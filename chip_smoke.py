"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It drives the port's main paths -- the
forward render through rk4_fwd and its gradient through rk4_ckpt and
rk4_bwd, the adaptive Dormand-Prince render and gradient through
dopri_fwd, dopri_ckpt and dopri_bwd, BASELINE config 4's multisampled
animation frame and massive particles through all six, the polarized
(Stokes) frame, the polarization maps and the Gen-1 hybrid renderer
through rk4_fwd, the learned surrogate trained on rk4_fwd's labels, the
sharded renders and the Trainer through rk4_ckpt and rk4_bwd, the
texture sampler's backward through tex_bwd, and the host surfaces: the
native runtime, the CLI's render of every example and
its animation, the compat API, utils.profiling and the four example
programs -- and fails (non-zero exit, no result
line) if anything is off:

  0. needs a CUDA device; prints the card's name and power limit;
  1. builds the kernels from the checkout's sources (build/kernels/), one
     nvcc per source, all at once, and with them the two witness builds
     of the same sources (NO_GUARD, IEEE);
  2. holds rk4_fwd against its plain PyTorch version on the card (a
     65,536-ray impact-parameter fan and a ragged batch with inside-horizon
     rays) and renders the 64x64 sky golden through it;
  3. renders the 1024x1024 flagship sky scene through ``render_image``,
     checks that rk4_fwd alone was launched and that the image agrees with
     the plain PyTorch render, and holds the kernel's final states of those
     1M rays against the plain integrator's;
  4. holds rk4_ckpt against rk4_fwd (final states) and each of its
     checkpoint rows against the plain step loop at the same step, on the
     fan, the ragged batch and the flagship rays, and its count of each
     ray's live segments against live_segments of its statuses (so do
     phases 9, 14 and 21 for the event, Kerr and dopri_ckpt variants);
  5. holds rk4_bwd against autograd of the plain step loop on the card:
     per-ray cotangents of x, p and E and the mass cotangent, on the fan
     (also cut to 40 steps, so rays are ACTIVE at the end) and on the
     ragged batch at all four step-size powers; and in both ray orders
     (``tile_order`` "cost" and "none", order_check): per-ray cotangents
     equal bit for bit, the mass, spin and sphere sums within
     TOL_GRAD_MASS, two runs the same bits (so do phases 10, 15, 18 for
     rk4_bwd and 22-25 for dopri_bwd, to TOL_DOPRI_GRAD_SCALAR);
  6. takes the flagship 1024x1024 gradient of mean(img^2) with respect to
     the mass, the camera position and the sky through ``render_image``,
     checks that rk4_ckpt and rk4_bwd were launched once each and rk4_fwd
     not at all, and holds it against the plain path: whole, and away from
     the rays circling the photon sphere and those ending near the sky's
     pole, where float32 conditions it badly (it reads how much those
     carry, and how far one ulp of camera moves the plain path); holds the
     per-ray cotangents of the flagship rays away from b_c; checks that
     rk4_bwd's scalar cotangents are the same bit for bit from run to run;
  7. times the forward render, the forward+backward step, and each kernel
     call against its plain version, and profiles the step;
  8. holds the event variant of rk4_fwd (a z = 0 disk and spheres) against
     the plain loop: 65,536 rays spread across the disk and the moons of
     bench.py's events scene, the ragged batch at the four step-size
     powers, the Schwarzschild case of tests/test_pallas.py's sphere-guard
     stress configuration and those rays through small spheres where the
     steps are long (where a guard band cut short would miss hits); statuses and
     hit ids equal, apart from a counted and capped set of rays that touch
     an event's edge (event_margin); renders the 64x64 goldens
     einstein_ring and disk_and_moons through it;
  9. holds rk4_ckpt's event variant against rk4_fwd's (bit for bit) and its
     checkpoint rows against the plain loop, those batches and the 1024^2
     events rays; and both kernels' outputs, checkpoints and live counts
     against the NO_GUARD build's (bit for bit: the sphere guard may skip
     only quadratics that find no entry);
 10. holds rk4_bwd's event variant against autograd of the plain loop, the
     (K, 4) sphere cotangent included, and checks that two runs give the
     same bits;
 11. renders bench.py's events scene (a disk and four moons, camera tilted
     by 0.25 rad) at 1024x1024 through render_image: the forward launches
     the event variant of rk4_fwd alone and agrees with the plain render,
     its final states with the plain integrator's; the gradient of
     mean(img^2) to the mass, the camera and the sky launches the event
     variants of rk4_ckpt and rk4_bwd once each and agrees with the plain
     path (the sky's whole; the mass and camera on the frame's calm
     pixels, see TOL_EVENTS_GRAD), and so does a gradient to a moon's
     centre and radius;
 12. times the events render, its forward+backward step and each event
     variant against its plain version, and profiles the step;
 13. holds the Kerr variants of rk4_fwd (event-free and with events)
     against the plain Kerr loop at a = 0.45 and a = -0.3 (M = 0.5): the
     fan and the ragged batch at the four powers (with the band around
     the Kerr critical impact parameter left out), the events fan over the
     disk and the moons, and a Kerr sphere-guard stress batch (short
     steps, spheres by the strong field, where a guard band without its
     |a| of slack misses entries); renders the 64x64 golden kerr_a09
     through them;
 14. holds the Kerr variants of rk4_ckpt against rk4_fwd's (bit for bit)
     and their checkpoint rows against the plain loop, and the event
     variants against the NO_GUARD build as phase 9 does;
 15. holds the Kerr variants of rk4_bwd against autograd of the plain Kerr
     loop, the spin cotangent included (the fan also cut to 40 steps, so
     rays are ACTIVE at the end), and checks that two runs give the same
     bits;
 16. runs bench.py's kerr-events frame (the events scene around a hole of
     a/M = 0.9) at 1024x1024 as phase 11 does, through the Kerr event
     variants alone, with the gradient to the spin too;
 17. times it as phase 12 does;
 18. runs bench.py's bench_integrator(spin=0.45) fan of 1M rays, forward
     and the gradient to the mass, through the Kerr variants without
     events alone: holds the mass gradient, each ray's final state (as
     phase 3), rk4_ckpt's against rk4_fwd's bit for bit and its
     checkpoint rows, and rk4_bwd's per-ray cotangents away from b_c (as
     phase 6) and from the step schedule's clip edges (near_kink) against
     the plain loop, and times it and each kernel;
 19. computes each kernel's bound at the main path's inputs: the ray-steps
     of its frame, the operations per ray-step counted on the plain
     statement of its variant, and the bytes it must move; for each
     rk4_fwd and rk4_ckpt variant on its frame (forward_rows) the
     registers, stack and spills ptxas reports, the resident blocks per
     SM, the SASS size and its census of special-function and slow-path
     instructions, the busy lanes and warps and the device time, and on
     the Kerr frames what the special-function unit's reciprocals move in
     rk4_fwd's outputs against the IEEE build (ieee_deviation); for each
     rk4_bwd variant on its frame (adjoint_table) the registers, stack and
     spills, the resident blocks per SM, the SASS size, the share of busy
     lanes and the device and call times in input and in cost order; and
     rk4_bwd's device time at seg 32 and 64 (the sky and the Kerr events
     frames at 400 and 2000 steps);
 20. holds dopri_fwd (adaptive Dormand-Prince, K4) against the plain trip
     loop on 65,536-ray fans (camera and events, Schwarzschild and a =
     0.45) at bench.py's adaptive configuration: the reference's
     invariants between two implementations (compare_adaptive), tighter on
     rays that took the same trips; and bench.py's dopri parity rows;
 21. holds dopri_ckpt (K5) against dopri_fwd bit for bit, and its
     checkpoint rows of (x, p, h, lam, status) against the plain loop's;
     and both kernels' outputs, checkpoints and live counts against the
     NO_GUARD build's, bit for bit;
 22. holds dopri_bwd (K6) against autograd of the plain checkpointed trip
     loop on the reference's weak-field fans (Schwarzschild and Kerr, with
     and without the disk and a sphere, also cut to 20 trips so rays are
     ACTIVE at the end), and checks that two runs give the same bits;
 23. renders BASELINE config 2, the 512x512 Einstein ring, through
     render_image: dopri_fwd's event variant alone, held to the golden
     einstein_ring_512 and its oracles and to the plain render; its
     gradient to the mass, camera, sky and the moon's centre and radius
     through dopri_ckpt and dopri_bwd alone, held to the plain path (the
     sky whole, the rest on the calm pixels); times;
 24. the same ring around a Kerr hole (a = 0.45): the Kerr event variants,
     the gradient's sky held to the plain path; times;
 25. runs bench.py's adaptive rows (bench_adaptive) at 262,144 rays,
     Schwarzschild and Kerr: the forward through dopri_fwd and the mass
     (and spin) gradient through dopri_ckpt and dopri_bwd, held to the
     plain path; times, the gradient in both ray orders;
 26. computes the Dormand-Prince kernels' bounds as phase 19 does, from the
     ray-trips of the plain trip loop replayed and the operations per trip
     counted on ``adjoint.dopri_trip`` and ``dopri_trip_vjp``; prints for
     each dopri_fwd and dopri_ckpt variant on its frame the table phase 19
     prints for rk4_fwd, with the share of trips rejected
     (dopri_forward_rows), and dopri_bwd's table as phase 19 does
     rk4_bwd's;
 27. renders BASELINE config 4's frame (bench.py bench_animation: the
     events scene from the orbit camera, SIZE^2 at ANIM_SAMPLES samples
     per pixel, frame 1 of ANIM_FRAMES) through render_image: the event
     variant of rk4_fwd once per sample and nothing else, the image against
     the plain render on the same draws as phase 11's, the first sample's
     final states as phase 11's; render_image_u8 against the host
     quantization of the float frame (equal; within one level with the
     tonemap); the orbit's frames through render_image_u8 and
     io_.write_png, one read back; times and frames/s;
 28. takes that frame's gradient of mean(img^2) to the mass, the camera
     and the sky: the event variants of rk4_ckpt and rk4_bwd once per
     sample each, held to the plain path as phase 11's (the sky whole, the
     mass and camera on the pixels calm in every sample); the sky
     cotangent of mean(img) equals the mean of the samples'; two runs;
     times, the device's busy share, each kernel's device ms and bound
     per sample, the checkpoint bytes autograd holds;
 29. render_progressive's last sample equals render_image, its 16 row
     bands the frame's rows bit for bit (one rk4_fwd launch each);
     render_stats and debug_rays against the plain path;
 30. launches PARTICLES massive particles (launch(..., time_like=True):
     circular and eccentric bound orbits, plunging and escaping particles,
     a band inside the horizon) through rk4_fwd, rk4_ckpt and rk4_bwd and
     through dopri_fwd, dopri_ckpt and dopri_bwd, each held to its plain
     version by its null-ray phase's rules without the photon-only parts
     (near b_c, sky directions): statuses, x, p and lam, Hh = -1/2 and the
     angular momentum conserved, the cotangents of the initial velocities
     and the mass, no NaN; each kernel's times and bound there;
 31. holds ks_directional_christoffel against the Metric.christoffel
     contraction (forward-mode AD of the Kerr-Schild metric) at 65,536
     points and a = 0.45, 0, -0.3; renders bench.py bench_stokes's
     POL_KERR^2 Kerr (a = 0.45) polarization map through
     polarization_map, the parallel-transport ODE in PyTorch operations:
     no kernel launched, |f.k| and |g(f,f) - g0| of the finished
     (escaped) rays away from b_c within FK_DRIFT and NORM_DRIFT (the
     schedule's long steps by the photon orbits drift by more: a
     reading), the map equal to its ODE run alone, and a seeded
     POL_SUBSET of its rays against the same function on the CPU
     (wrapped angles away from b_c, NaN patterns but for capped
     escape-edge rays); times;
 32. renders bench_stokes's SIZE^2 frame (the events disk with pol_frac
     0.7) through render_stokes: rk4_fwd's event variant once and nothing
     else, rgb against the plain render, the rays' final states as phase
     11, Q and U within TOL_STOKES where the statuses agree; the flagship
     sky's SIZE^2 Schwarzschild polarization map through rk4_fwd against
     the plain map; K1's times and bound on the Stokes frame; times;
 33. renders bench.py _surrogate_image_compare's HYBRID^2 Kerr (a = 0.45)
     Gen-1 frame through render_limited (rk4_fwd_kerr once) and a
     Schwarzschild Gen-1 frame with a disk, a lit moon and debug colours
     (rk4_fwd_events once), each against the plain render (image, shadow
     pixels within SHADOW_PX, debug colours) and its rays against the
     plain loop; the rays render_limited pre-sets ESCAPED or
     INSIDE_HORIZON come back from rk4_fwd bit for bit; holds
     SurrogateTable.build through rk4_fwd against the plain build on the
     CPU (captured equal, exit directions within TOL_DIR away from b_c)
     and renders the approx frame from its table; K1's times and bound on
     each frame and the table; times;
 34. renders the two full-size goldens of tests/test_golden_baseline.py
     that phase 23's ring leaves out, each one launch of render_image:
     disk_four_moons_1024 (BASELINE config 3, RK4 400 steps) through
     rk4_fwd_events and kerr_a09_512 (a/M = 0.9, the camera edge-on to the
     spin axis) through rk4_fwd_kerr, held to the file's rule (the image
     4x pooled in float16: mean drift, cells moved by > 0.05) and oracles
     (the orange disk above the shadow; > 1,000 dark pixels, top/bottom
     asymmetry > 0.05), each reading on its own line; never writes one;
 35. builds the learned surrogate at full width (256 x 5) from
     init_params and holds its f32 trace of SUR_RAYS entries on the card
     to the same model's on the CPU, its bf16 trace to f32 by the JAX
     test's bars; times both; the equivariance residual;
 36. trains the surrogate (train_surrogate, a = 0.45, SUR_STEPS steps of
     SUR_BATCH rays), each step's labels one rk4_fwd_kerr launch: the loss
     falls, evaluate_surrogate on SUR_EVAL rays meets the JAX CPU test's
     bars, K1's labels of a batch equal the plain loop's (statuses but
     MAX_EDGE near b_c; the state tolerances elsewhere); ms a step, K1's
     device ms and bound on the batch; bench.py _surrogate_image_compare's
     HYBRID^2 Kerr frame exact and through the model (PSNR, shadow-edge
     displacement: readings); save and load trace the same bits;
 37. renders through parallel.render_image_sharded on the one-rank mesh
     (the round-robin deal and its layout inverse, no collective): the
     flagship frame equal to render_image bit for bit, at ANIM_SAMPLES
     samples on the same draws (one rk4_fwd launch for all) within
     SHARDED_MEAN; render_stokes_sharded and polarization_map_sharded
     equal to their unsharded forms; times;
 38. the Trainer (bench.py bench_sharded): one step at 512^2 with
     mask_critical 0.25, rk4_ckpt and rk4_bwd once each, its gradients to
     the mass, camera and sky against the plain path's within
     TOL_TRAINER_GRAD; the 1024^2 step's time, loss, device busy share
     and K2/K3 device ms and bounds; test_trainer_recovers_mass's fit,
     the mass within 0.05;
 39. saves and loads the fit's training state after three steps
     (torch.save and npz): the fourth step equals an uninterrupted run's
     bit for bit;
 40. builds the native runtime (the C++ oracle, PNG/PFM IO and the async
     FrameWriter) from the port's copy of its sources into build/native/
     and fails with the compiler's message if it does not build; its
     status codes equal ops/states.py's; the FrameWriter writes config
     4's SIZE^2 uint8 frame (examples/orbit_animation.json), which decodes
     back equal; the native encoder's ms against the pure-zlib encoder's;
 41. ``cli render`` of every examples/*.json at its own size, in this
     process: the kernel variant of its path (K1's, or K4 for the
     Dormand-Prince ring), once per row band or sample, and no plain loop;
     the decoded PNG equal to the host quantization of the port's own
     render of build_scene(cfg) bit for bit; that render against the
     plain render by phase 27's image rule (phase 23's for the ring, 33's
     for the hybrid, 32's for the Stokes frame, its Q/U bound away from
     b_c and the ulp-sensitive rays); the Stokes example's _stokes.npz
     equal to render_stokes's planes; wall ms per example;
 42. ``cli animate examples/orbit_animation.json`` at SIZE^2 x
     ANIM_SAMPLES spp, ANIM_FRAMES frames through the native FrameWriter:
     every frame equal to render_image_u8 of its orbit camera, then the
     last frame deleted and ``--resume`` making every file byte-identical;
     frames/s and the device's busy share over the command;
 43. ``precompute-camera`` at 124^2 through one rk4_fwd launch, held to
     the plain path on the card, its npz round trip; compat's native
     backend against the torch one; ``train-surrogate`` (200 steps at
     limited_hybrid.json's mass, ratio and exit tolerance) and that config
     rendered through the npz, another ratio refused; ``profile-train``'s
     op table with rk4_ckpt and rk4_bwd and a collective share of 0;
 44. utils.profiling: ``profile_steps`` over phase 3's SIZE^2 forward, its
     op table naming the rk4_fwd kernel at phase 7's CUDA-event time
     within PROFILE_AGREE; ``device_memory_stats`` (0 < peak <= limit);
     ``profile_collectives`` on one rank (share 0, overlap NaN);
 45-48. the example programs (``examples.parameter_study``,
     ``kerr_faraday``, ``fit_orbit``, ``tutorial``) at their default
     arguments, each ``main`` in this process on the card: exit code 0,
     which is each script's own physics checks (Bardeen's shadow edges
     within 1%, the deflection series, beaming; the Faraday signatures;
     mass, phase and roll recovered within 1%); the kernel variants each
     launches and no plain loop; parameter_study's deflection angles
     against the CPU plain loop within TOL_DEFLECTION, kerr_faraday's a
     = 0 map against the CPU's within TOL_POL away from b_c; each
     example's wall seconds, launches and the device's busy share (a
     second run traced through utils.profiling; for kerr_faraday
     FARADAY_BUSY_STAGES transport stages);
 49. the texture sampler's backward (ops/csrc/tex_bwd.cu) at the orbit
     fit's shapes: the six sample_bpy calls of config 4's frame 1 at
     SIZE^2 x ANIM_SAMPLES samples in one call with a 512 x 1024 sky
     (the sky's with its texture cotangent, the disk's and the moons'
     without), the seam and pole batches of the CPU test, a g with NaN and
     infinities and an all-zero g: against the plain path (TOL_TEX_XY and
     the summation bound of dtex), dtex bit for bit against the same
     fixed-point sum taken with torch, two runs bit for bit, one launch a
     call; the warps' texel groups; the six calls' device ms beside their
     bound, the plain path's and the sky's four index_put_, and each
     variant's call ms, device ms and bound.  The six calls are the plain
     shading's of the frame's rays: on the card the renders shade through
     shade_fwd and shade_bwd (phase 50), which call no sample_bpy;
 50. the shading kernels (ops/csrc/shade.cu, shade_bwd.cu) at the two
     cells' sizes, SIZE^2 x ANIM_SAMPLES rays: config 4's frame 1 (the
     orbit cell's scene: a learned 512 x 1024 sky, the disk, four textured
     moons) and the Kerr cell's face-on frame (a = 0.45, a beaming disk):
     the colours and every cotangent against the plain shading and its
     autograd (TOL_SHADE_FRAME, TOL_SHADE_RAY, TOL_SHADE_SCENE; the rays
     that part counted and held to MAX_SHADE_PARTED), two backward runs bit
     for bit,
     one launch of each; the forward's call ms and device ms beside its
     bound and the plain shading's, the backward's without and with the
     sky's texture cotangent beside theirs and the plain path's.  Every
     render gradient's launch check above counts shade_fwd, shade_bwd and
     shade_tex (a learned texture) beside the integrator's kernels.

The two-rank paths (the sample group's all_reduce, the ray group's
all_gather, the gradient average) need two ranks; two NCCL ranks cannot
share one card, so tests/test_torch_distributed.py holds them on the CPU
with gloo.

Every check of a phase is recorded; after the last phase the run fails if
any check failed.  Each phase's seconds are logged.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launch count on the main paths
(``launches_by_path`` when more than one runs it), error, times and
bound, and for the variants of phases 28, 30, 32, 33, 36 and 38 their
readings there; phases 41-43 add the CLI's paths to ``launches_by_path``,
phases 44-48 utils.profiling's and the example programs'.
Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
import unittest.mock
import zlib
from pathlib import Path

import numpy as np
import torch

import blackhole_geodesic_calculator_tpu_torch as P
from blackhole_geodesic_calculator_tpu_torch import cli, compat, native
from blackhole_geodesic_calculator_tpu_torch.camera.pinhole import (
    generate_rays, pixel_grid)
from blackhole_geodesic_calculator_tpu_torch.examples import (
    fit_orbit, kerr_faraday, parameter_study, tutorial)
from blackhole_geodesic_calculator_tpu_torch.io_ import (
    build_scene, load_config, load_train_state, save_train_state, tonemap,
    write_png)
from blackhole_geodesic_calculator_tpu_torch.io_.config import build_limited
from blackhole_geodesic_calculator_tpu_torch.io_.image import _png_bytes
from blackhole_geodesic_calculator_tpu_torch.models.kerr import (
    horizon_radius, kerr_ks_metric)
from blackhole_geodesic_calculator_tpu_torch.models import surrogate
from blackhole_geodesic_calculator_tpu_torch.models.surrogate import (
    NeuralSurrogate, SurrogateConfig, _label_env, _straight_exit,
    canonicalize, evaluate_surrogate, init_params, label_rays,
    load_surrogate, sample_entries, save_surrogate, train_surrogate)
from blackhole_geodesic_calculator_tpu_torch.ops import (
    _build, adjoint, cuda_kernel, states)
from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import (
    hamiltonian, null_init, timelike_init)
from blackhole_geodesic_calculator_tpu_torch.ops.integrate import (
    DiskGeom, GeodesicEnv, SphereGeom, _disk_event, _dopri_trip, _dt_eff,
    _fixed_step, _sphere_events, dopri_h0, dopri_step, final_direction,
    rk4_step)
from blackhole_geodesic_calculator_tpu_torch.ops.polarization import (
    _cross, _unit, ks_directional_christoffel, plane_normal,
    transport_polarization_ode)
from blackhole_geodesic_calculator_tpu_torch.parallel import (
    polarization_map_sharded, render_stokes_sharded)
from blackhole_geodesic_calculator_tpu_torch.parallel.render import (
    render_samples, slot_jitter)
from blackhole_geodesic_calculator_tpu_torch.render import (
    debug_rays, format_debug_string, limited, render_progressive,
    render_sample, render_stats, sample_draws)
from blackhole_geodesic_calculator_tpu_torch.render import renderer
from blackhole_geodesic_calculator_tpu_torch.render.renderer import (
    _bh_frame, scene_env)
from blackhole_geodesic_calculator_tpu_torch.scene.shading import (
    disk_uv, shade, shade_rays, shade_scene)
from blackhole_geodesic_calculator_tpu_torch.scene import texture
from blackhole_geodesic_calculator_tpu_torch.scene.texture import (
    equirect_uv, sample_bpy, sample_bpy_bwd_plain)
from blackhole_geodesic_calculator_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent
PKG = "blackhole_geodesic_calculator_tpu_torch"
PALLAS = "blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py"
KERNELS = {   # name -> (source in the repo, the TPU kernel it replaces)
    "rk4_fwd": (f"{PKG}/ops/csrc/rk4_fwd.cu", f"{PALLAS}:1159"),
    "rk4_ckpt": (f"{PKG}/ops/csrc/rk4_ckpt.cu", f"{PALLAS}:1201"),
    "rk4_bwd": (f"{PKG}/ops/csrc/rk4_bwd.cu", f"{PALLAS}:1258"),
    # the event variants (disk and sphere events, EV > 0 in the sources)
    "rk4_fwd_events": (f"{PKG}/ops/csrc/rk4_fwd.cu", f"{PALLAS}:1159"),
    "rk4_ckpt_events": (f"{PKG}/ops/csrc/rk4_ckpt.cu", f"{PALLAS}:1201"),
    "rk4_bwd_events": (f"{PKG}/ops/csrc/rk4_bwd.cu", f"{PALLAS}:1258"),
    # the Kerr variants (KERR in the sources), event-free and with events
    "rk4_fwd_kerr": (f"{PKG}/ops/csrc/rk4_fwd.cu", f"{PALLAS}:1159"),
    "rk4_ckpt_kerr": (f"{PKG}/ops/csrc/rk4_ckpt.cu", f"{PALLAS}:1201"),
    "rk4_bwd_kerr": (f"{PKG}/ops/csrc/rk4_bwd.cu", f"{PALLAS}:1258"),
    "rk4_fwd_kerr_events": (f"{PKG}/ops/csrc/rk4_fwd.cu", f"{PALLAS}:1159"),
    "rk4_ckpt_kerr_events": (f"{PKG}/ops/csrc/rk4_ckpt.cu", f"{PALLAS}:1201"),
    "rk4_bwd_kerr_events": (f"{PKG}/ops/csrc/rk4_bwd.cu", f"{PALLAS}:1258"),
}
# the adaptive Dormand-Prince kernels (K4-K6), in the same four variants
for _kind, _line in (("fwd", 473), ("ckpt", 749), ("bwd", 804)):
    for _suffix in ("", "_events", "_kerr", "_kerr_events"):
        KERNELS[f"dopri_{_kind}{_suffix}"] = (
            f"{PKG}/ops/csrc/dopri_{_kind}.cu", f"{PALLAS}:{_line}")
# the texture sampler's backward, with and without the texture cotangent:
# no TPU kernel, the JAX package's is XLA's quad scatter
for _name in ("tex_bwd_dtex", "tex_bwd"):
    KERNELS[_name] = (f"{PKG}/ops/csrc/tex_bwd.cu",
                      "none (XLA: blackhole_geodesic_calculator_tpu/scene/"
                      "texture.py:144 _sample_bpy_bwd)")
# the final direction and the shading, each ray by its status, and their
# backward (shade_tex: its texture scatter): no TPU kernel, the JAX
# package's is XLA's dense shading
for _name, _src in (("shade_fwd", "shade.cu"), ("shade_fwd_kerr", "shade.cu"),
                    ("shade_bwd", "shade_bwd.cu"),
                    ("shade_bwd_kerr", "shade_bwd.cu"),
                    ("shade_tex", "shade_bwd.cu")):
    KERNELS[_name] = (f"{PKG}/ops/csrc/{_src}",
                      "replaces none: XLA's dense shading, JAX "
                      "scene/shading.py")

# Tolerances of the kernels against their plain versions.  Both are
# float32; they differ in rsqrtf against torch.rsqrt and in nvcc's fused
# multiply-adds, a few ulp per step, amplified near the photon sphere.
TOL_X = 1e-3       # position and affine parameter, absolute
TOL_P = 1e-4       # momentum, absolute (Kerr: of max(1, |p|))
TOL_DIR = 1e-4     # final direction, radians: 1/8 of the flagship pixel
# rk4_bwd against autograd of the plain loop: largest |difference| of each
# per-ray cotangent (x, p, E) over the largest |value| of the plain one
# (readings on an H100: at most 1.6e-5 on the fan, the ragged batch and the
# flagship rays away from b_c), and the mass cotangent's relative
# difference (reading 1.6e-4 on the fan).
TOL_GRAD = 1e-4
TOL_GRAD_MASS = 1e-3
# The flagship gradient, kernel path against plain path: the mass, the
# camera position and the sky (largest |difference| over largest |value|).
# It is ill-conditioned in float32: the rays near b_c carry 95% of it, and
# the sky's checker channel varies along u at the pole rows, which the
# camera looks at, so rays that end near the pole have cotangents ~ 1/rho.
# Moving the plain path's camera by one ulp moves it by 1.45e-2; the kernel
# path reads 8.4e-3 from the plain one (H100).
TOL_FLAGSHIP_GRAD = 3e-2
# ... away from b_c and from within POLE_RHO rad of the sky's pole, where
# it is well conditioned.
POLE_RHO = 0.05
TOL_CALM_GRAD = 1e-3
# The events frame's sky gradient (reading 3.0e-3 on an H100, and float32
# alone moves it by 3.0e-3), kernel path against plain path, and its
# gradient to a moon's centre and radius (reading 2.0e-5).  Its calm pixels
# -- away from b_c, the sky's pole, the disk texture's seam, the
# silhouettes, ill-conditioned events and texel flips -- are held to
# TOL_CALM_GRAD (readings 8.6e-6 mass, 8.3e-6 camera, 4.2e-6 sky; the
# plain path with the camera one ulp away reads 8.3e-5 and 2.0e-5).
TOL_EVENTS_GRAD = 1e-2
TOL_MOON_GRAD = 1e-3
# A texel flip is a pixel whose sky or disk lookup falls in another texel
# cell on the kernel path than on the plain one, its end point moved by a
# few float32 ulp.  The bilinear lookup's derivative jumps at a texel
# centre, by the whole contrast at the sky checker's edges: 9 such calm
# pixels of the 1M carried all of a 1.6e-3 difference in the frame's mass
# gradient (H100).  They are counted and capped.
MAX_TEXEL_FLIPS = 64
# The golden rule of tests/test_golden.py for whole images: the 64x64
# golden render against its checked-in image.
GOLDEN_MEAN = 2e-3
GOLDEN_FRAC = 0.01
# The flagship image through the kernel against the plain render on the
# card, set from the readings (mean |d| 8.0e-7, no element off by > 0.1 on
# an H100): a kernel that stopped a step early or got the step budget wrong
# changes a few hundred of the 1M pixels and fails it.
FLAGSHIP_MEAN = 1e-5
FLAGSHIP_FRAC = 1e-5
# At most this many rays of one comparison may end a step apart (see
# step_apart); the readings were 1 of 65,536 fan rays and 0 elsewhere.
MAX_ALIGNED = 8
SIZE = 1024        # the flagship image is SIZE x SIZE
FAN = 65536        # rays of the impact-parameter fan
INTEGRATOR_RAYS = 1024 * 1024   # bench.py's bench_integrator fan
# Rays that touch an event's edge: a segment that grazes a sphere, crosses
# z = 0 at r_in or r_out or with an end on the plane, enters a sphere at
# an end of the segment, or meets the disk and a sphere at the same point.
# There one ulp can flip the event between two correct float32 paths.  A
# ray whose status or hit id differs between the kernel and the plain loop
# must lie within EVENT_EPS (a length; the paths' x agree to TOL_X) of such
# an edge on some step, and at most MAX_EDGE of them per comparison.
EVENT_EPS = 1e-3
MAX_EDGE = 8
# The float32 conditioning of the event that ended a ray (event_kappa): a
# disk crossing's t = -z / (z1 - z0) moves by L / |z1 - z0| times a change
# of z, a sphere entry's t by |bb| / sqrt(disc) times a relative change of
# the quadratic's terms.  Rays whose event is worse conditioned than
# KAPPA_CALM -- shallow disk crossings, sphere grazes -- carry cotangents
# that two correct float32 paths part on; they are held to TOL_GRAD_EVENTS
# of the largest value, the other rays to TOL_GRAD.
KAPPA_CALM = 10.0
TOL_GRAD_EVENTS = 1e-2
POWERS = (1.5, 1.0, 2.0, 1.3)
# The Kerr spins held (M = 0.5): a/M = 0.9, bench.py's kerr rows, and a
# retrograde a/M = -0.6.
SPINS = (0.45, -0.3)
# Half the band, in M, around a Kerr hole's critical impact parameter whose
# rays are held as near b_c (Schwarzschild: 0.3 M).  The Kerr step has
# about three times the operations, so two float32 paths part farther
# from b_c: at 0.3 M the fans read |dp| 1.2e-4 and lam a step apart (H100).
KERR_BAND = 0.5
# Dormand-Prince, kernel against the plain trip loop.  The reference's
# invariants between two implementations (tests/test_pallas.py:187-206,
# bench.py:296-304): statuses (and hit ids) equal on >= 99.8% of the rays,
# lam within max_step, the directions of rays that end on the sky within
# 2e-3 rad.  Two float32 controllers part on accept and reject where the
# error norm sits at 1 (its float32 rounding is ~1e-3 of it) and then
# sample the same path at other points; rays whose lam agrees within TOL_X
# took the same trips, and away from b_c their sky directions are held to
# TOL_DIR.  At most DOPRI_APART of the rays away from b_c may take other
# trips (a CPU emulation of the kernels read up to 0.51 on the Kerr fans; a
# controller with another constant moves nearly all of them).
DOPRI_AGREE = 0.998
DOPRI_ANGLE = 2e-3
DOPRI_APART = 0.8
# An event ray freezes where the chord of its last step meets the disk or a
# sphere, so two samplings of one path put its event point apart by the
# chords' error: an H100 read 2.2e-2 on the events fans (max_step 8) and
# 3.4e-4 on the Einstein rings (max_step 2).  The positions of checkpoint
# rows of rays whose lam agrees within TOL_X part as far (8.1e-3).
DOPRI_EVENT_X = 5e-2
# dopri_bwd against autograd of the plain trip loop, loss of final
# directions and event points (the reference's, tests/test_pallas.py:262):
# the median over the rays that end on the sky or are still ACTIVE and took
# the same trips of each ray's |difference| over its |value| (ray_rel), for
# the cotangents of x and p, and the mass, spin and sphere cotangents,
# relative, to the reference's 5e-2.  The median, because float32 h
# sequences that part by ~1% on a few rays move their cotangents by up to
# 2e-2 (an H100 reading) while the typical ray agrees to ~1e-6 (a CPU
# emulation of the kernels); the emulation's adjoint without the errn -> h
# term, a trip long or restarting from h0 moved the medians to 2e-4 - 1e-1.
# An event point is where a straight chord of the last step meets the disk
# or a sphere: two samplings of one path put it apart by the chord's error
# and its derivative further, so the event rays' cotangents are a reading.
TOL_DOPRI_GRAD = 2e-4
TOL_DOPRI_GRAD_SCALAR = 5e-2
# bench.py's adaptive gradient row: its own gate between two
# implementations, the mass gradient within 1e-2 (bench.py:594-600); the
# spin's (a Kerr fan; the loss sum(x^2) reads where each escaped ray's last
# step overshoots r_escape, and the spin's part of it is small) within the
# reference's 5e-2, TOL_DOPRI_GRAD_SCALAR.
TOL_ADAPTIVE_GRAD = 1e-2
ADAPTIVE_RAYS = 512 * 512   # bench.py's bench_adaptive fan
RING = 512                  # the Einstein ring (BASELINE config 2) is RING^2
# BASELINE config 4 (bench.py bench_animation): SIZE^2 frames of the events
# scene at ANIM_SAMPLES samples per pixel from an orbit of ANIM_FRAMES
# cameras; the frame held is frame 1 of the orbit.
ANIM_SAMPLES = 5
ANIM_FRAMES = 10
# Massive particles of the timelike fan (phase 30), and its limits: the
# super-Hamiltonian of a particle still in flight after K1 within H_DRIFT of
# -1/2 (tests/test_timelike.py's 5e-4); Dormand-Prince particles on the same
# trips are those whose lam agrees within SAME_TRIP, and every particle in
# flight keeps its angular momentum x cross p within TOL_L of max(1, |L|)
# (the CPU test's; a particle's end on another trip is elsewhere on its
# orbit).
PARTICLES = 1024 * 1024
H_DRIFT = 5e-4
# A ray is as ill-conditioned as one near b_c (ulp_sensitive) when one ulp
# of its start moves its plain path by more than ULP_SHARE of a state
# tolerance; a particle near its orbit's separatrix (near_separatrix) when
# its E^2 lies within SEP_BAND of the peak of its effective potential --
# the unstable circular orbits at r = 4-6 M among them, where one ulp
# moves p by 1.4e-4 within 100 steps (a CPU replay; 8e-6 for the others).
ULP_SHARE = 0.1
SEP_BAND = 1e-3
SAME_TRIP = 1e-4
TOL_L = 1e-4
# Phases 31-33 (polarization and the Gen-1 hybrid).  The Kerr polarization
# map is POL_KERR^2 (bench.py bench_stokes's psize); POL_SUBSET of its rays
# are held against the same function on the CPU, away from b_c to TOL_POL
# rad (wrapped).  ks_directional_christoffel is held to the AD Christoffel
# contraction within TOL_CHRISTOFFEL of each point's largest entry (the
# reference test's rtol 2e-5 plus its atol of 2e-5 of the largest entry;
# reading on the CPU at 65,536 points 1.2e-5), the transport's invariants
# on the finished rays to FK_DRIFT and NORM_DRIFT
# (tests/test_polarization.py's).  The Stokes Q and U against the plain
# render within TOL_STOKES on the rays whose status agrees.  The hybrid
# frames are HYBRID^2 (bench.py _surrogate_image_compare's size), held to
# the plain render's image by HYBRID_MEAN and HYBRID_FRAC (a debug-coloured
# pixel that flips at an edge moves whole channels by 1) and to its shadow
# pixel count within SHADOW_PX (tests/test_limited.py's gate); the surrogate
# table's exit directions to TOL_DIR on the escaping rays TABLE_BAND or
# more from b_c (nearer, rays circle the photon sphere and part).
POL_KERR = 256
POL_SUBSET = 1024
TOL_POL = 1e-3
TOL_CHRISTOFFEL = 4e-5
FK_DRIFT = 1e-4
NORM_DRIFT = 1e-3
TOL_STOKES = 1e-3
HYBRID = 512
HYBRID_MEAN = 1e-4
HYBRID_FRAC = 1e-4
SHADOW_PX = 4
TABLE_BAND = 0.25
# Phases 34-39 (the training half).  The full-size goldens of
# tests/test_golden_baseline.py by its own rule (_check_golden :50-62): the
# image 4x mean-pooled in float16, mean drift below GOLDEN_DRIFT and fewer
# than GOLDEN_MOVED of the cells moved by more than 0.05.  The learned
# surrogate at full width (256 x 5): its f32 trace on the card against the
# CPU's over SUR_RAYS rays (bench.py bench_surrogate's batch) within TOL_SUR
# (directions; exit points relative to the exit shell's radius on the rays
# whose point before the projection onto the shell lies R/2 or more from
# the centre: an untrained network puts some near it, where the
# projection's division multiplies a rounding by up to the shell's radius
# over that distance -- H100: 4.4e-6 there, 1.8e-4 on all; TF32 would read
# ~1e-3), trained SUR_STEPS steps (train_surrogate's default; bench.py's
# 15,000 are the bench's) of SUR_BATCH rays, evaluated on SUR_EVAL.  The
# sharded multisampled frame within SHARDED_MEAN mean |d| of render_image
# on the same draws.  The Trainer's gradients within TOL_TRAINER_GRAD of
# the plain path's (bench.py bench_sharded's gate, :690-699); the mass fit
# FIT_STEPS Adam steps (tests/test_parallel.py).
GOLDEN_DRIFT = 1e-3
GOLDEN_MOVED = 0.005
SUR_RAYS = 1 << 21
SUR_STEPS = 2000
SUR_BATCH = 8192
SUR_EVAL = 1 << 17
TOL_SUR = 1e-5
SHARDED_MEAN = 1e-6
TOL_TRAINER_GRAD = 1e-2
FIT_STEPS = 60
# Phase 49 (the texture sampler's backward, csrc/tex_bwd.cu) at the orbit
# fit's shapes: a TEX_SKY sky (the benchmark's 512 x 1024) under config 4's
# frame 1 at SIZE^2 x ANIM_SAMPLES samples in one call, as the Trainer
# renders them.  dx and dy repeat the plain path's roundings and add the
# channels in order, which torch.sum need not keep: within TOL_TEX_XY (two
# ulp) of the largest |value|.  dtex is the kernel's fixed-point sum: each
# of the n_t terms of texel t rounded to the quantum 2^-k (k from the
# largest |g|, cuda_kernel.tex_bwd_exponent), the sum exact, then one
# rounding to float32 (u = 2^-24).  The plain path's float32 sums of the
# same terms in some order are within (n_t - 1) u sum_t |term| of the exact
# sum (Higham's bound for recursive summation).  So each texel is held to
# (n_t + 1) u sum_t |term| + n_t 2^-(k+1).  The kernel's dtex also equals,
# bit for bit, the same fixed-point sum taken with torch (tex_reference).
TEX_SKY = (512, 1024)
TOL_TEX_XY = 2.0 ** -22
# Phase 50 (the shading kernels) at the cells' frames, against the plain
# shading and its autograd on the same final states, both float32, as
# tests/test_torch_cuda.py's shading tests compare them.  The colours
# differ by the direction's last bits (rhs's reciprocal square roots and
# fused multiply-adds against ks_fields' forms), which the longitude near
# the sky's pole turns by 1 / |(d_x, d_y)|, and which the 512 x 1024 sky's
# slopes (32 times the tests' 16 x 32 sky's) carry into the colour: within
# TOL_SHADE_FRAME (readings on an H100, PERF.md §7: 29 rays above it
# in the orbit frame, at most 1.22e-4; 167 in the face-on Kerr frame, 13
# above 1e-3, all sky rays within 0.2 of the pole's direction).  A ray's
# cotangents of x, p and E within TOL_SHADE_RAY of its own scale
# (ray_gaps; 10 and 46 rays above it).  A ray beyond either parts; the
# parted rays are counted and held to MAX_SHADE_PARTED of the rays.  The
# sky's cotangent is compared without the parted rays' and the rays
# within SKY_POLE_CAP of the sky's pole (their colour cotangent set to 0
# on both sides; readings 1.5e-5 orbit, 5.1e-4 Kerr of its largest
# entry, against TOL_SHADE_SCENE; 1.2e-3 in Kerr with the pole's).  The
# mass's and the spin's, sums over 5.24M rays with much cancellation, are
# held to TOL_SHADE_RAY of the sum of the plain path's per-ray terms'
# magnitudes (scalar_terms), the bound the per-ray tolerance implies.
TOL_SHADE_FRAME = 1e-4
TOL_SHADE_RAY = 1e-4
MAX_SHADE_PARTED = 1e-4
TOL_SHADE_SCENE = 1e-3
SKY_POLE_CAP = 0.01
# The card's peak rates for the bound of each kernel (NVIDIA's data sheet
# for the H100 SXM at 700 W, float32 outside the tensor cores).
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
DEVICE = "cuda"
# The witness builds of the same sources (rk4_step.cuh, _build.built_with):
# without the sphere guard, whose outputs rk4_fwd's and rk4_ckpt's (phases
# 9 and 14) and dopri_fwd's and dopri_ckpt's (phase 21) must equal bit for
# bit; and with IEEE forms of the special-function unit's reciprocals and
# of the trip's controller, against which phases 19 and 26 read what they
# move in the Kerr forward.
NO_GUARD = ("BHGC_SPHERE_GUARD=0",)
IEEE = ("BHGC_IEEE_RECIPROCALS=1",)

FAILURES: list[str] = []
# phase 1's build of the native runtime: whether it built, and its seconds
NATIVE_BUILD: dict = {}
# The readings each kernel's entry in the kernels line must carry.
KERNEL_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """Record a failed check; the run fails after its last phase."""
    if not ok:
        FAILURES.append(msg)
        log(f"# FAILED: {msg}")


def phase(name: str, fn, *args):
    """Run one phase; an AssertionError inside it is recorded as a failed
    check and the phase returns None.  Logs the phase's seconds."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    except AssertionError as e:
        check(False, f"{name}: {e}")
        return None
    finally:
        log(f"# [{name}] {time.perf_counter() - t0:.1f} s")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship_cfg(backend="auto"):
    return P.RenderConfig(
        width=SIZE, height=SIZE, samples=1,
        integrator=P.IntegratorConfig(
            n_steps=100, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
            dt_power=1.5, backend=backend),
        lam_max=100.0)


def make_sky(h=256, w=512, check=16):
    """The procedural equirect sky of the flagship (bench.py make_sky) and,
    at 32x64 with 8-pixel checks, of the goldens (tests/test_golden.py)."""
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * u / w) * np.sin(np.pi * v / h),
        v / h,
        ((u // check + v // check) % 2).astype(np.float32)], -1)


def camera_fan(n, dev, gap=(2.45, 2.75)):
    """n camera-style rays, impact parameters b in [1.5, 2.45] u [2.75, 12]
    at z = 25, direction (0, 0, -1) (bench.py camera_fan); ``gap`` moves
    the band left out around the critical impact parameter."""
    b = np.concatenate([np.linspace(1.5, gap[0], n // 2),
                        np.linspace(gap[1], 12.0, n - n // 2)])
    ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return f(x0), f(d0)


def ragged_batch(n, dev, seed=0, gap=(2.45, 2.75)):
    """n rays (not a multiple of the block size) with random impact
    parameters in the fan's bands, azimuths and start heights, a tenth of
    them starting inside the horizon (r_s = 1)."""
    rng = np.random.default_rng(seed)
    b = np.where(rng.random(n) < 0.5, rng.uniform(1.5, gap[0], n),
                 rng.uniform(gap[1], 12.0, n))
    ang = rng.uniform(0.0, 2 * np.pi, n)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang),
                   rng.uniform(15.0, 30.0, n)], -1)
    inside = rng.random(n) < 0.1
    x0[inside] = rng.uniform(-0.5, 0.5, (int(inside.sum()), 3))
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return f(x0), f(d0)


def initial_state(env, x0, d0):
    """The state ``launch`` integrates: null_init, INSIDE_HORIZON marked."""
    p0, E0 = null_init(x0, d0, env.mass, env.spin)
    s0 = states.init_state(x0.contiguous(), p0, E0)
    s0.status = s0.status.masked_fill(env.radius(x0) <= env.r_capture,
                                      states.INSIDE_HORIZON)
    return s0


def rays(s, k):
    """The rays ``k`` (a mask or indices) of state ``s``."""
    return dataclasses.replace(s, x=s.x[k], p=s.p[k], E=s.E[k], lam=s.lam[k],
                               status=s.status[k], hit_obj=s.hit_obj[k])


def step_apart(env, cfg, a, b):
    """Align rays that end one step apart in the two paths.

    Where a ray's radius or affine parameter lands within rounding of
    r_escape, r_capture or lam_max, the termination test can flip between
    two correct float32 paths: both end with the same status, one a step
    later.  The earlier one must then sit on that boundary; step it once
    more with the plain step so the two can be compared.  Returns (a, b,
    count)."""
    far = (a.lam - b.lam).abs() > TOL_X
    count = int(far.sum())
    if count > MAX_ALIGNED:
        raise AssertionError(f"{count} rays end a step apart "
                             f"(at most {MAX_ALIGNED})")

    def advance(s, mask):
        if not bool(mask.any()):
            return s
        sub = dataclasses.replace(rays(s, mask),
                                  status=torch.zeros_like(s.status[mask]))
        r = env.radius(sub.x)
        edge = (((r >= env.r_escape) & (r - env.r_escape <= TOL_X))
                | ((r <= env.r_capture) & (env.r_capture - r <= TOL_X))
                | ((sub.lam >= env.lam_max)
                   & (sub.lam - env.lam_max <= TOL_X)))
        if not bool(edge.all()):
            raise AssertionError("rays end a step apart off a boundary")
        nxt = _fixed_step(env, cfg, sub)
        out = dataclasses.replace(s, x=s.x.clone(), p=s.p.clone(),
                                  lam=s.lam.clone(), status=s.status.clone())
        out.x[mask], out.p[mask] = nxt.x, nxt.p
        out.lam[mask], out.status[mask] = nxt.lam, nxt.status
        return out

    early_a = far & (a.lam < b.lam)
    early_b = far & (b.lam < a.lam)
    return advance(a, early_a), advance(b, early_b), count


def compare_states(env, cfg, a, b, what):
    """Kernel state ``a`` against plain state ``b``; returns the largest
    absolute error in x, p and lam and the count of rays aligned by
    step_apart."""
    if not a.status.numel():
        return 0.0, 0
    st_a, st_b = a.status.cpu().numpy(), b.status.cpu().numpy()
    n_bad = int((st_a != st_b).sum())
    if n_bad:
        raise AssertionError(f"{what}: {n_bad} statuses differ")
    a, b, n_apart = step_apart(env, cfg, a, b)
    if not torch.equal(a.status, b.status):
        raise AssertionError(f"{what}: statuses differ after alignment")
    dx = float((a.x - b.x).abs().max())
    dpv = (a.p - b.p).abs()
    if env.spin is not None:
        # a Kerr hole's captured rays end with |p| up to 5.5 (a = 0.45;
        # 3.6 in Schwarzschild): p is held relative to max(1, |p|)
        dpv = dpv / b.p.norm(dim=-1, keepdim=True).clamp_min(1.0)
    dp = float(dpv.max())
    dl = float((a.lam - b.lam).abs().max())
    # angle between unit vectors as 2 asin(|a - b| / 2): arccos of the dot
    # product loses everything below ~3e-4 rad in float32
    chord = (final_direction(env, a) - final_direction(env, b)).norm(dim=-1)
    dang = float((2.0 * torch.asin((0.5 * chord.double()).clamp(max=1.0)))
                 .max())
    log(f"# parity [{what}] n={st_a.size} statuses equal, "
        f"{n_apart} end a step apart at a boundary; max|dx|={dx:.3e} "
        f"max|dp|={dp:.3e} max|dlam|={dl:.3e} max_dir={dang:.3e} rad")
    if not (dx <= TOL_X and dl <= TOL_X and dp <= TOL_P and dang <= TOL_DIR):
        raise AssertionError(
            f"{what}: outside tolerance (x/lam {TOL_X}, p {TOL_P}, "
            f"direction {TOL_DIR} rad)")
    return max(dx, dp, dl), n_apart


def near_b_c(env, s0):
    """Rays whose impact parameter L/E lies near the critical one: in
    [4.9, 5.5] M, the band the fan leaves out around b_c = 3 sqrt(3) M, or
    for a Kerr hole (photon_band) within KERR_BAND of the critical sky
    radius of rays with no angular momentum about the spin axis, and
    anywhere in the photon region's band for the others; and for a Kerr
    hole the rays
    that start inside the photon region.  They circle near the photon
    orbits, where each orbit multiplies a rounding difference by about
    e^(2 pi), so two correct float32 paths part."""
    L = torch.linalg.cross(s0.x, s0.p, dim=-1)
    b_imp = L.norm(dim=-1) / s0.E
    m = float(env.mass)
    if env.spin is None:
        return (b_imp >= 4.9 * m) & (b_imp <= 5.5 * m)
    rho_c, lo, hi, r_out = photon_band(m, float(env.spin))
    axial = (L[..., 2] / s0.E).abs() < 0.05
    inside = env.radius(s0.x) <= r_out
    return inside | torch.where(axial,
                                (b_imp - rho_c).abs() <= KERR_BAND * m,
                                (b_imp >= lo) & (b_imp <= hi))


def photon_band(m, a):
    """(rho_c, lo, hi, r_out) of a Kerr hole of mass m and spin a: the
    critical sky radius sqrt(eta + a^2) of rays with L_z = 0 (the spherical
    photon orbit with xi = 0: r^3 - 3 m r^2 + a^2 r + a^2 m = 0), the band
    of impact parameters from the prograde to the retrograde equatorial
    photon orbit, each widened by 0.3 m (Bardeen's xi(r), eta(r)), and the
    outer edge of the photon region (the retrograde orbit's radius) plus
    0.3 m."""
    a2 = a * a
    r = max(z.real for z in np.roots([1.0, -3.0 * m, a2, a2 * m])
            if abs(z.imag) < 1e-9 and z.real > m)
    eta = -r ** 3 * (r ** 3 - 6 * m * r * r + 9 * m * m * r - 4 * a2 * m) / (
        a2 * (r - m) ** 2)
    rho_c = float(np.sqrt(eta + a2))

    def xi(r):
        return abs((r ** 3 - 3 * m * r * r + a2 * r + a2 * m)
                   / (abs(a) * (r - m)))

    r_pro = 2 * m * (1 + np.cos(2 / 3 * np.arccos(-abs(a) / m)))
    r_ret = 2 * m * (1 + np.cos(2 / 3 * np.arccos(abs(a) / m)))
    return (rho_c, float(xi(r_pro)) - 0.3 * m, float(xi(r_ret)) + 0.3 * m,
            float(r_ret) + 0.3 * m)


def ulp_sensitive(env, cfg, s0, sp):
    """Rays whose plain path ``sp`` from ``s0`` moves by more than
    ULP_SHARE of a state tolerance (or changes its status or hit id) when
    its start moves by one ulp: two correct float32 paths part on them as
    on the rays near b_c, and are held so.  Jittered samples land on such
    rays outside near_b_c's band (a band's edge at 5.5 M, where rays still
    circle the photon sphere)."""
    with torch.no_grad():
        sq = cuda_kernel.integrate_plain(env, dataclasses.replace(
            s0, x=s0.x * (1.0 + 2.0 ** -23)), cfg)
    lim = ULP_SHARE
    return ((sq.status != sp.status) | (sq.hit_obj != sp.hit_obj)
            | ((sq.lam - sp.lam).abs() > lim * TOL_X)
            | ((sq.x - sp.x).abs().amax(-1) > lim * TOL_X)
            | (((sq.p - sp.p).abs() / sp.p.norm(dim=-1, keepdim=True)
                .clamp_min(1.0)).amax(-1) > lim * TOL_P))


def compare_flagship(env, cfg, s0, a, b, what=None, near=None):
    """Kernel state ``a`` against plain state ``b`` for every flagship ray.

    Statuses must be equal everywhere.  Rays near b_c (see near_b_c) part
    by more than the state tolerances (up to 1.2e-2 in lam on an H100), so
    they are held to lam within half a step instead: a ray that took a step
    more or fewer in one path fails.  All other rays are held to the full
    tolerances of compare_states.  ``near`` replaces near_b_c's band by
    another mask of rays held so.  Returns (error, rays aligned, largest
    |d lam| in the band)."""
    what = what or f"{SIZE}x{SIZE} flagship"
    if not torch.equal(a.status, b.status):
        n_bad = int((a.status != b.status).sum())
        raise AssertionError(f"{what}: {n_bad} statuses differ")
    if near is None:
        near = near_b_c(env, s0)
    err, n = compare_states(env, cfg, rays(a, ~near), rays(b, ~near),
                            f"{what}, away from b_c")
    # a ray near b_c a whole step apart must end at a boundary (step_apart)
    dl = (a.lam - b.lam).abs()
    jump = near & (dl >= 0.5 * cfg.dt)
    aj, bj, n_jump = step_apart(env, cfg, rays(a, jump), rays(b, jump))
    n += n_jump
    dl = torch.cat([dl[near & ~jump], (aj.lam - bj.lam).abs()])
    dlam = float(dl.max()) if dl.numel() else 0.0
    log(f"# parity [{what}, near b_c] n={int(near.sum())} statuses equal, "
        f"max|dlam|={dlam:.3e} (limit {0.5 * cfg.dt:g}, half a step)")
    if not dlam < 0.5 * cfg.dt:
        raise AssertionError(f"{what}: a ray near b_c is a step apart")
    return err, n, dlam


def image_rule(img, ref, what, max_mean, max_frac):
    """Mean |img - ref| below ``max_mean`` and a share of elements off by
    more than 0.1 below ``max_frac``."""
    diff = (img - ref).abs()
    mean, frac = float(diff.mean()), float((diff > 0.1).float().mean())
    log(f"# image [{what}] mean|d|={mean:.3e} frac(|d|>0.1)={frac:.3e} "
        f"(limits {max_mean:g}, {max_frac:g})")
    if not (mean < max_mean and frac < max_frac):
        raise AssertionError(f"{what}: image outside its limits")


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def timed(fn, runs=10):
    """Median host-clock ms of ``fn`` over ``runs`` runs after a warm-up,
    each run ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def once(fn):
    """(fn(), host-clock ms of that one call, synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def once_ms(fn):
    """Host-clock ms of one call of ``fn`` (a plain path, seconds long: no
    warm-up, nothing to compile)."""
    return once(fn)[1]


def backward_ms(forward):
    """Host-clock ms of one ``forward().backward()``'s backward."""
    loss = forward()
    return once(loss.backward)[1]


def profile(fn, runs=10):
    """torch.profiler over ``runs`` runs of ``fn`` after a warm-up."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return prof


def device_ms(fn, runs=10):
    """Median device ms of the kernels ``fn`` launches, between two CUDA
    events recorded around it behind a kernel that keeps the stream busy
    (torch.cuda._sleep), so that the host's launch overhead does not open
    gaps on the device between them."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def step_profile(step, wall, what, name_limit, runs=5):
    """Where a step's device time goes: the device kernels (and copies) the
    profiler records over ``runs`` steps, by name, against the step's wall
    time ``wall`` (ms)."""
    from torch.autograd import DeviceType

    prof = profile(step, runs=runs)
    by_name: dict[str, list[float]] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            t = by_name.setdefault(ev.name, [0.0, 0])
            t[0] += ev.time_range.elapsed_us() / runs / 1e3
            t[1] += 1
    total = sum(t for t, _ in by_name.values())
    log(f"# {what}, device busy {total:.3f} ms per step over "
        f"{sum(c for _, c in by_name.values()) // runs} kernel launches, "
        f"{100 * total / wall:.1f}% of the {wall:.3f} ms step (profiler, "
        f"mean of {runs}) [{name_limit}]")
    for key, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"#   {t:8.3f} ms {100 * t / max(total, 1e-9):5.1f}%  "
            f"x{c // runs:<4d} {key[:90]}")
    return total, total / wall


# =============================================================================
# Phases.
# =============================================================================
def timed_native_build():
    """(native.available(), seconds): the native runtime's build (make,
    g++ and zlib) and load."""
    t0 = time.perf_counter()
    return native.available(), time.perf_counter() - t0


def phase_build():
    t0 = time.perf_counter()
    # the shipped library and the witness builds, all at once, and beside
    # them the native runtime (phase 40 fails if it did not build)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        built = pool.submit(timed_native_build)
        lib_path, *_ = pool.map(_build.build, [(), NO_GUARD, IEEE])
        NATIVE_BUILD.update(zip(("ok", "s"), built.result()))
    _build.load()
    log(f"# phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"-> {lib_path.relative_to(ROOT)}; the native runtime "
        + (f"built in {NATIVE_BUILD['s']:.1f} s -> "
           f"{native._LIB_PATH.relative_to(ROOT)}" if NATIVE_BUILD["ok"]
           else f"FAILED to build: {native.load_error()}"))
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "error" in line):
            log(f"#   ptxas: {line.strip()}")


def fan_env(dev):
    return GeodesicEnv(
        mass=torch.tensor(0.5, device=dev),
        r_capture=torch.tensor(1.0, device=dev),
        r_escape=torch.tensor(70.0, device=dev),
        lam_max=torch.tensor(100.0, device=dev))


def phase_fwd(env, icfg, dev, readings):
    on = lambda b, **kw: dataclasses.replace(icfg, backend=b, **kw)  # noqa
    x0, d0 = camera_fan(FAN, dev)
    err, aligned = compare_states(
        env, icfg, P.launch(env, x0, d0, on("cuda")),
        P.launch(env, x0, d0, on("torch")), f"fan {FAN}")
    x0r, d0r = ragged_batch(1000, dev)
    for power in POWERS:
        sk = P.launch(env, x0r, d0r, on("cuda", dt_power=power))
        sp = P.launch(env, x0r, d0r, on("torch", dt_power=power))
        e, n = compare_states(env, on("torch", dt_power=power), sk, sp,
                              f"ragged 1000 power={power}")
        aligned += n
        if power == 1.5:
            err = max(err, e)
            inside = sk.status == states.INSIDE_HORIZON
            if not bool(inside.any()) or not torch.equal(sk.x[inside],
                                                         x0r[inside]):
                raise AssertionError("inside-horizon rays moved")

    golden = np.load(ROOT / "tests" / "golden" / "schwarzschild_sky.npz")
    ref = torch.as_tensor(golden["img"].astype(np.float32), device=dev)
    gs = make_sky(32, 64, check=8)
    gscene = P.Scene(bh=P.BlackHole.make(mass=0.5, device=dev),
                     background=torch.as_tensor(gs, dtype=torch.float32,
                                                device=dev))
    gcam = P.Camera.make(position=(0.0, 0.0, 20.0), fov=(0.7, 0.7),
                         device=dev)
    gcfg = P.RenderConfig(width=64, height=64, integrator=P.IntegratorConfig(
        n_steps=400, dt=0.08), lam_max=120.0)
    image_rule(P.render_image(gscene, gcam, gcfg), ref,
               "64x64 golden, kernel", GOLDEN_MEAN, GOLDEN_FRAC)
    readings["rk4_fwd"].update(max_abs_err=err, rays_aligned=aligned)
    log("# phase 2: rk4_fwd agrees with plain PyTorch on the card")


def phase_flagship_fwd(scene, cam, dev, readings):
    cfg, cfg_plain = flagship_cfg(), flagship_cfg(backend="torch")
    reset_counts()
    img = P.render_image(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    readings["rk4_fwd"]["launches"] = launches.get("rk4_fwd", 0)
    check(launches == only(rk4_fwd=1),
          f"forward render launched {launches}, expected rk4_fwd once")
    if img.shape != (SIZE, SIZE, 4) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"flagship image is not a finite {SIZE}x{SIZE}x4")
    with torch.no_grad():
        img_plain = P.render_image(scene, cam, cfg_plain)
    image_rule(img, img_plain, f"{SIZE}x{SIZE} flagship, kernel vs plain",
               FLAGSHIP_MEAN, FLAGSHIP_FRAC)

    # the flagship's rays themselves: some run all n_steps or end on the
    # budget, which the fan and the ragged batch never do
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    with torch.no_grad():
        s = cuda_kernel.integrate_cuda(fenv, s0, cfg.integrator)
        e, n, dlam_near = compare_flagship(
            fenv, cfg.integrator, s0, s,
            cuda_kernel.integrate_plain(fenv, s0, cfg.integrator))
    r = readings["rk4_fwd"]
    r.update(max_abs_err=max(r.get("max_abs_err", 0.0), e),
             rays_aligned=r.get("rays_aligned", 0) + n,
             dlam_near_b_c=dlam_near)
    hist = torch.bincount(s.status.reshape(-1).long(), minlength=8).tolist()
    names = ("ACTIVE", "CAPTURED", "ESCAPED", "BUDGET", "DISK", "OBJECT",
             "INSIDE_HORIZON", "ERROR")
    log(f"# phase 3: flagship {SIZE}x{SIZE} rendered through rk4_fwd "
        f"(launches={launches}); statuses "
        + " ".join(f"{k}={v}" for k, v in zip(names, hist) if v))


def flagship_rays(scene, cam, cfg, dev, size=SIZE, jitter=None):
    """A frame's environment and initial ray state, as render_image builds
    them, with (size, size) batch shape (the flagship's SIZE); ``jitter``
    one sample's draws (render_image's sample_draws)."""
    ys, xs = pixel_grid(size, size, device=dev)
    o, d = generate_rays(cam, size, size, ys, xs, jitter)
    fenv = scene_env(scene, cfg, cam)
    return fenv, initial_state(fenv, o, d)


def flat_state(s):
    """``s`` as contiguous (n, ...) tensors, as the kernel wrappers take."""
    return dataclasses.replace(
        s, x=s.x.reshape(-1, 3).contiguous(),
        p=s.p.reshape(-1, 3).contiguous(), E=s.E.reshape(-1).contiguous(),
        lam=s.lam.reshape(-1).contiguous(),
        status=s.status.reshape(-1).contiguous(),
        hit_obj=s.hit_obj.reshape(-1).contiguous())


def reset_counts():
    cuda_kernel.LAUNCHES.clear()


def read_counts():
    """The launches of each integrator and texture kernel variant
    (ops/cuda_kernel.py's LAUNCHES, by the names of KERNELS) since
    reset_counts; the shading kernels' are read_shading's."""
    return {name: n for name, n in cuda_kernel.LAUNCHES.items()
            if n and not name.startswith("shade_")}


def read_shading():
    """The launches of the shading kernels (shade_fwd, shade_bwd,
    shade_tex and their Kerr variants) since reset_counts."""
    return {name: n for name, n in cuda_kernel.LAUNCHES.items()
            if n and name.startswith("shade_")}


def shading(kerr=False, fwd=0, bwd=0, tex=0):
    """The shading launches of ``fwd`` forward renders through
    render_rays, ``bwd`` backwards and ``tex`` texture scatters (a
    backward with a texture that needs its cotangent)."""
    k = "_kerr" if kerr else ""
    return only(**{f"shade_fwd{k}": fwd, f"shade_bwd{k}": bwd,
                   "shade_tex": tex})


def only(**launches):
    """The launch counts of a run that launched just ``launches``."""
    return {name: n for name, n in launches.items() if n}


def no_grad(fn):
    """``fn`` run under torch.no_grad."""
    def run():
        with torch.no_grad():
            return fn()
    return run


def ckpt_rows(ck, k, s0):
    cx, cp, clam, cst, _ = ck
    return dataclasses.replace(s0, x=cx[k], p=cp[k], lam=clam[k],
                               status=cst[k])


def live_equal(ck, what):
    """rk4_ckpt's or dopri_ckpt's count of each ray's live segments (the
    last entry of ``ck``) against its plain version on the kernel's own
    checkpoint statuses; the log's word for it."""
    same = torch.equal(ck[-1], cuda_kernel.live_segments(ck[-2]))
    check(same, f"{what}: the live-segment counts differ from "
          "live_segments of the checkpoint statuses")
    return "live counts equal" if same else "live counts DIFFER"


def event_kw(env, s0):
    """The event and spacetime arguments of the kernel wrappers for
    ``env``."""
    return dict(sph=cuda_kernel._sphere_table(env, s0.x.device),
                has_disk=env.disk is not None, obj=s0.hit_obj,
                kerr=env.spin is not None)


def run_ckpt(env, cfg, s0):
    """rk4_fwd and rk4_ckpt on the flat state ``s0``."""
    scal = cuda_kernel._scalars(env, cfg, s0.x.device)
    n, pw = cfg.n_steps, float(cfg.dt_power)
    kw = event_kw(env, s0)
    fwd = cuda_kernel.rk4_fwd(scal, s0.x, s0.p, s0.E, s0.lam, s0.status, n,
                              pw, **kw)
    *fin, ck = cuda_kernel.rk4_ckpt(scal, s0.x, s0.p, s0.E, s0.lam,
                                    s0.status, n, cuda_kernel.segment(n), pw,
                                    **kw)
    return fwd, fin, ck


def phase_ckpt(env, icfg, scene, cam, dev, readings):
    """rk4_ckpt's final states against rk4_fwd's, and its checkpoint rows
    against the plain loop's states at the same steps."""
    err, bitwise = 0.0, True
    cases = [(f"fan {FAN}", initial_state(env, *camera_fan(FAN, dev)),
              icfg, env)]
    xr, dr = ragged_batch(1000, dev)
    cases += [(f"ragged 1000 power={pw}", initial_state(env, xr, dr),
               dataclasses.replace(icfg, dt_power=pw), env) for pw in POWERS]
    cfg = flagship_cfg()
    fenv, fs0 = flagship_rays(scene, cam, cfg, dev)
    cases.append((f"{SIZE}x{SIZE} flagship", flat_state(fs0), cfg.integrator,
                  fenv))
    for what, s0, c, e in cases:
        with torch.no_grad():
            fwd, fin, ck = run_ckpt(e, c, s0)
            same = all(torch.equal(a, b) for a, b in zip(fwd, fin))
            bitwise &= same
            final = dataclasses.replace(s0, x=fin[0], p=fin[1], lam=fin[2],
                                        status=fin[3])
            if not same:   # held to rk4_fwd's tolerances instead
                k1 = dataclasses.replace(s0, x=fwd[0], p=fwd[1], lam=fwd[2],
                                         status=fwd[3])
                err = max(err, compare_states(e, c, final, k1,
                                              f"{what}: rk4_ckpt vs rk4_fwd")
                          [0])
            seg = cuda_kernel.segment(c.n_steps)
            plain, rows = cuda_kernel.integrate_ckpt_plain(e, s0, c, seg)
            # rays that end a step apart at a boundary (phase 2) are
            # checked there; leave them out of the row comparisons
            keep = (final.lam - plain.lam).abs() <= TOL_X
            for k, row in enumerate(rows):
                a, b = ckpt_rows(ck, k, s0), row
                label = f"{what}: checkpoint row {k} (step {k * seg})"
                if "flagship" in what:
                    err = max(err, compare_flagship(e, c, s0, a, b, label)[0])
                else:
                    err = max(err, compare_states(e, c, rays(a, keep),
                                                  rays(b, keep), label)[0])
        log(f"# phase 4: [{what}] rk4_ckpt final state "
            + ("equals rk4_fwd's bit for bit" if same
               else "differs from rk4_fwd's (held to its tolerances)")
            + f"; {len(rows)} checkpoint rows of seg {seg} agree; "
            + live_equal(ck, what))
    readings["rk4_ckpt"].update(max_abs_err=err, equals_rk4_fwd=bitwise)


def weighted_x_loss(s, wx):
    """The loss of tests/test_pallas.py:82-92: a weighted sum of final
    positions over rays neither CAPTURED nor ERROR."""
    ok = ((s.status != states.CAPTURED) & (s.status != states.ERROR))
    return torch.where(ok[..., None], wx * s.x, 0.0).sum()


def integrator_grads(env, s0, cfg, loss_fn, kernel):
    """Cotangents of (x, p, E) of ``s0`` and of the mass, for
    ``loss_fn(final state)``, through the kernels or the plain loop."""
    mass = env.mass.detach().clone().requires_grad_(True)
    e = dataclasses.replace(env, mass=mass)
    x, p, E = (t.detach().clone().requires_grad_(True)
               for t in (s0.x, s0.p, s0.E))
    s = dataclasses.replace(s0, x=x, p=p, E=E)
    out = (cuda_kernel.integrate_cuda(e, s, cfg) if kernel
           else cuda_kernel.integrate_plain(e, s, cfg))
    loss_fn(out).backward()
    return out, (x.grad, p.grad, E.grad, mass.grad)


def compare_grads(out_k, gk, out_p, gp, what):
    """Per-ray cotangents of x, p, E and the mass cotangent, kernel against
    plain; rays that end a step apart at a boundary are left out."""
    keep = (out_k.lam - out_p.lam).abs() <= TOL_X
    errs = [rel_err(a[keep], b[keep]) for a, b in zip(gk[:3], gp[:3])]
    dm = abs(float(gk[3]) / float(gp[3]) - 1.0)
    log(f"# grad [{what}] n={int(keep.sum())} of {keep.numel()}: "
        f"x {errs[0]:.3e} p {errs[1]:.3e} E {errs[2]:.3e} "
        f"(max |d| / max |plain|), mass {float(gk[3]):.7g} vs "
        f"{float(gp[3]):.7g} (rel {dm:.3e})")
    check(max(errs) <= TOL_GRAD and dm <= TOL_GRAD_MASS,
          f"{what}: cotangents outside tolerance ({TOL_GRAD:g}, mass "
          f"{TOL_GRAD_MASS:g})")
    return max(errs + [dm])


def order_check(tag, name, launch, tol, readings):
    """The adjoint ``name`` in cost order, again, and in input order
    (``launch(tile_order)`` returns its outputs): the per-ray cotangents of
    x, p and E equal bit for bit, the mass and spin cotangents (relative)
    and the sphere cotangent (to its largest entry), summed in another
    order, within ``tol``, and the two runs in cost order the same bits."""
    with torch.no_grad():
        cost, again, plain = launch("cost"), launch("cost"), launch("none")
    per_ray = all(torch.equal(a, b) for a, b in zip(cost[:3], plain[:3]))
    same = all(torch.equal(a, b) for a, b in zip(cost, again))
    apart = [abs(float(cost[3][q]) / float(plain[3][q]) - 1.0) for q in (0, 9)
             if float(plain[3][q]) != 0.0]
    if plain[4].numel():
        apart.append(rel_err(cost[4], plain[4]))
    spread = max(apart, default=0.0)
    log(f"# {tag}: {name} in cost and in input order: per-ray cotangents "
        + ("equal bit for bit" if per_ray else "DIFFER")
        + f"; mass, spin and sphere cotangents apart by {spread:.3e} (limit "
        f"{tol:g}); two runs in cost order "
        + ("equal bit for bit" if same else "DIFFER"))
    check(per_ray, f"{tag}: {name}'s per-ray cotangents depend on the order")
    check(same, f"{tag}: {name} in cost order is not deterministic")
    check(spread <= tol, f"{tag}: {name}'s scalar or sphere cotangents part "
          f"by {spread:.3e} between the ray orders (limit {tol:g})")
    r = readings[name]
    r["order_spread"] = max(r.get("order_spread", 0.0), spread)


def rk4_order_check(tag, env, cfg, s0, w, readings):
    """order_check of rk4_bwd on rk4_ckpt's checkpoints of the flat state
    ``s0``, with the cotangent ``w`` for the final x and p; held to
    TOL_GRAD_MASS."""
    with torch.no_grad():
        _, _, ck = run_ckpt(env, cfg, s0)
        scal = cuda_kernel._scalars(env, cfg, s0.x.device)
    kw = event_kw(env, s0)
    del kw["obj"]
    seg = cuda_kernel.segment(cfg.n_steps)
    name = cuda_kernel.variant("rk4_bwd", env.spin is not None,
                               env.disk is not None or env.spheres is not None)
    order_check(tag, name, lambda o: cuda_kernel.rk4_bwd(
        scal, ck, s0.E, w, w, cfg.n_steps, seg, float(cfg.dt_power),
        tile_order=o, **kw), TOL_GRAD_MASS, readings)


def phase_bwd(env, icfg, dev, readings):
    """rk4_bwd against autograd of the plain loop on the card."""
    rng = np.random.default_rng(2)
    cases = [(f"fan {FAN}", camera_fan(FAN, dev), icfg),
             (f"fan {FAN}, 40 steps",
              camera_fan(FAN, dev), dataclasses.replace(icfg, n_steps=40))]
    rb = ragged_batch(1000, dev)
    cases += [(f"ragged 1000 power={pw}", rb,
               dataclasses.replace(icfg, dt_power=pw)) for pw in POWERS]
    err = 0.0
    for what, (x0, d0), c in cases:
        s0 = initial_state(env, x0, d0)
        wx = torch.as_tensor(rng.normal(size=tuple(x0.shape)),
                             dtype=torch.float32, device=dev)
        loss = lambda s: weighted_x_loss(s, wx)  # noqa: E731
        out_k, gk = integrator_grads(env, s0, c, loss, kernel=True)
        out_p, gp = integrator_grads(env, s0, c, loss, kernel=False)
        active = int((out_k.status == states.ACTIVE).sum())
        err = max(err, compare_grads(out_k, gk, out_p, gp,
                                     f"{what}, {active} ACTIVE at the end"))
        rk4_order_check(f"phase 5 [{what}]", env, c, s0, wx, readings)
    readings["rk4_bwd"]["max_abs_err"] = err
    log("# phase 5: rk4_bwd agrees with autograd of the plain loop")


def shade_as(cfg):
    """The shading of a render of ``cfg``: the kernels (shade_rays) or, with
    the plain integrator (backend "torch"), the plain shading
    (final_direction + shade), so that a plain reference is the plain path
    throughout."""
    if cfg.integrator.backend != "torch":
        return contextlib.nullcontext()
    return unittest.mock.patch.object(
        renderer, "shade_rays",
        lambda env, scene, s: shade(scene, s, final_direction(env, s)))


def render_grads(scene0, cam0, cfg, mask=None):
    """d mean(img[..., :3]^2) (bench.py:385-391) / d (mass, camera
    position, sky) and, for a Kerr hole, / d spin; ``mask`` (H, W) weights
    the pixels."""
    leaf = lambda t: t.detach().clone().requires_grad_(True)  # noqa: E731
    bh = scene0.bh
    scene = dataclasses.replace(
        scene0,
        bh=dataclasses.replace(
            bh, mass=leaf(bh.mass),
            spin=None if bh.spin is None else leaf(bh.spin)),
        background=leaf(scene0.background))
    cam = dataclasses.replace(cam0, position=leaf(cam0.position))
    with shade_as(cfg):
        sq = P.render_image(scene, cam, cfg)[..., :3].pow(2)
        if mask is not None:
            sq = sq * mask[..., None]
        sq.mean().backward()
    out = (scene.bh.mass.grad, cam.position.grad, scene.background.grad)
    return out if bh.spin is None else out + (scene.bh.spin.grad,)


def compare_render_grads(gk, gp, what, tol):
    errs = [rel_err(a, b) for a, b in zip(gk, gp)]
    spin = (f"; spin {float(gk[3]):.7g} vs {float(gp[3]):.7g} (rel "
            f"{errs[3]:.3e})" if len(gk) > 3 else "")
    log(f"# grad [{what}] mass {float(gk[0]):.7g} vs {float(gp[0]):.7g} "
        f"(rel {errs[0]:.3e}); camera {gk[1].tolist()} vs {gp[1].tolist()} "
        f"({errs[1]:.3e}); sky {errs[2]:.3e} (max |d| / max |plain|)"
        + spin)
    check(max(errs) <= tol, f"{what}: gradients outside tolerance {tol:g}")
    return errs


def shade_loss(scene, env, s, n_pix):
    """The render's loss as a function of the integrator's final state."""
    rgb = shade(_bh_frame(scene), s, final_direction(env, s))
    return rgb.pow(2).sum() / (3 * n_pix)


def phase_flagship_grad(scene, cam, dev, readings):
    cfg, cfg_plain = flagship_cfg(), flagship_cfg(backend="torch")
    # the main path: the gradient of the flagship frame
    reset_counts()
    gk = render_grads(scene, cam, cfg)
    torch.cuda.synchronize()
    launches, shaded = read_counts(), read_shading()
    for name in ("rk4_ckpt", "rk4_bwd"):
        readings[name]["launches"] = launches.get(name, 0)
    check(launches == only(rk4_ckpt=1, rk4_bwd=1)
          and shaded == shading(fwd=1, bwd=1, tex=1),
          f"forward+backward launched {launches}, {shaded}, expected "
          "rk4_ckpt, rk4_bwd, shade_fwd, shade_bwd and the sky's shade_tex "
          "once each and rk4_fwd never")
    for g in gk:
        check(bool(torch.isfinite(g).all()), "flagship gradient not finite")
    gp = render_grads(scene, cam, cfg_plain)
    compare_render_grads(gk, gp, f"{SIZE}x{SIZE} flagship, kernel vs plain",
                         TOL_FLAGSHIP_GRAD)

    # how much of it the rays circling the photon sphere carry
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    away = (~near_b_c(fenv, s0)).float()
    gk_away = render_grads(scene, cam, cfg, away)
    gp_away = render_grads(scene, cam, cfg_plain, away)
    # the loss is linear in the pixel weights: full = away + band
    share = [float((gk[i] - gk_away[i]).norm() / gk[i].norm())
             for i in (0, 1)]
    log(f"# grad [{SIZE}x{SIZE} flagship] the {int((away == 0).sum())} "
        f"pixels near b_c carry |g_band| / |g| = {share[0]:.3e} of the mass "
        f"gradient and {share[1]:.3e} of the camera gradient (kernel path)")
    compare_render_grads(gk_away, gp_away,
                         f"{SIZE}x{SIZE} flagship away from b_c, kernel vs "
                         "plain (a reading)", float("inf"))
    # ... and away from the sky's pole too, where the gradient is well
    # conditioned: held tightly
    with torch.no_grad():
        end = final_direction(fenv, cuda_kernel.integrate_plain(
            fenv, s0, cfg.integrator))
    rho = end[..., :2].norm(dim=-1)
    calm = (away.bool() & (rho >= POLE_RHO)).float()
    log(f"# grad [{SIZE}x{SIZE} flagship] {int((rho < POLE_RHO).sum())} "
        f"rays end within {POLE_RHO:g} rad of the sky's pole")
    compare_render_grads(render_grads(scene, cam, cfg, calm),
                         render_grads(scene, cam, cfg_plain, calm),
                         f"{SIZE}x{SIZE} flagship away from b_c and the "
                         "pole, kernel vs plain", TOL_CALM_GRAD)

    # the float32 conditioning of that gradient: the plain path against
    # itself with the camera moved by one ulp in z
    cam_ulp = dataclasses.replace(cam, position=cam.position.clone())
    cam_ulp.position[2] = torch.nextafter(cam.position[2],
                                          cam.position[2] + 1)
    compare_render_grads(render_grads(scene, cam_ulp, cfg_plain), gp,
                         f"{SIZE}x{SIZE} flagship, plain vs plain with the "
                         "camera one ulp away (a reading)", float("inf"))
    compare_render_grads(render_grads(scene, cam_ulp, cfg_plain, away),
                         gp_away, f"{SIZE}x{SIZE} flagship away from b_c, "
                         "plain vs plain one ulp away (a reading)",
                         float("inf"))

    # per-ray cotangents of the integrator's inputs, away from b_c, for a
    # loss smooth in the final state (weighted positions and directions)
    near = near_b_c(fenv, s0)
    wx, wd = (torch.as_tensor(np.random.default_rng(k).normal(
        size=(SIZE, SIZE, 3)), dtype=torch.float32, device=dev)
        for k in (4, 5))

    def smooth(s):
        ok = (s.status != states.CAPTURED) & (s.status != states.ERROR)
        f = wx * s.x + wd * final_direction(fenv, s)
        return torch.where(ok[..., None], f, 0.0).sum()

    out_k, rk = integrator_grads(fenv, s0, cfg.integrator, smooth, True)
    out_p, rp = integrator_grads(fenv, s0, cfg.integrator, smooth, False)
    errs = [rel_err(a[~near], b[~near]) for a, b in zip(rk[:3], rp[:3])]
    log(f"# grad [{SIZE}x{SIZE} flagship rays away from b_c, smooth loss] "
        f"per-ray cotangents x {errs[0]:.3e} p {errs[1]:.3e} E "
        f"{errs[2]:.3e}; near b_c: x "
        f"{rel_err(rk[0][near], rp[0][near]):.3e} (max |d| / max |plain|)")
    check(max(errs) <= TOL_GRAD,
          f"flagship per-ray cotangents away from b_c outside {TOL_GRAD:g}")

    # the render's own loss per ray: where it parts, and how near the pole
    loss = lambda s: shade_loss(scene, fenv, s, SIZE * SIZE)  # noqa: E731
    _, rk = integrator_grads(fenv, s0, cfg.integrator, loss, True)
    _, rp = integrator_grads(fenv, s0, cfg.integrator, loss, False)
    bad = ((rk[0] - rp[0]).abs().amax(-1)
           > 1e-3 * rp[0][~near].abs().max()) & ~near
    far = float(rho[bad].max()) if bool(bad.any()) else 0.0
    log(f"# grad [{SIZE}x{SIZE} flagship rays away from b_c, render loss] "
        f"per-ray x cotangent {rel_err(rk[0][~near], rp[0][~near]):.3e}; "
        f"{int(bad.sum())} rays differ by > 1e-3 of the largest, all within "
        f"{far:.3e} rad of the sky's pole (a reading)")

    # the scalar cotangents from rk4_bwd are the same bit for bit
    rng = np.random.default_rng(3)
    gx, gpp = (torch.as_tensor(rng.normal(size=(SIZE * SIZE, 3)),
                               dtype=torch.float32, device=dev)
               for _ in range(2))
    flat, icfg = flat_state(s0), cfg.integrator
    with torch.no_grad():
        _, _, ck = run_ckpt(fenv, icfg, flat)
        runs = [cuda_kernel.rk4_bwd(
            cuda_kernel._scalars(fenv, icfg, dev), ck, flat.E, gx, gpp,
            icfg.n_steps, cuda_kernel.segment(icfg.n_steps), icfg.dt_power)
            for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    gk2 = render_grads(scene, cam, cfg)
    sky_spread = float((gk2[2] - gk[2]).abs().max() / gk[2].abs().max())
    mass_same = "equal" if torch.equal(gk2[0], gk[0]) else "differs"
    log(f"# determinism: two rk4_bwd runs on the flagship rays give "
        + ("bitwise-equal" if same else "DIFFERENT")
        + f" outputs (mass cotangent {float(runs[0][3][0]):.9g}); two "
        f"flagship gradients: mass {mass_same}, sky spread max|d|/max|g| = "
        f"{sky_spread:.3e}")
    check(same, "rk4_bwd is not deterministic from run to run")
    readings["rk4_bwd"]["sky_grad_spread"] = sky_spread
    log("# phase 6: flagship gradient through rk4_ckpt and rk4_bwd agrees "
        "with the plain path")


def phase_times(scene, cam, dev, name_limit, readings):
    cfg, cfg_plain = flagship_cfg(), flagship_cfg(backend="torch")
    rays_n = SIZE * SIZE
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    icfg = cfg.integrator
    flat = flat_state(s0)
    scal = cuda_kernel._scalars(fenv, icfg, dev)
    seg = cuda_kernel.segment(icfg.n_steps)
    args = (scal, flat.x, flat.p, flat.E, flat.lam, flat.status)

    fwd_render = no_grad(lambda: P.render_image(scene, cam, cfg))
    step = lambda: render_grads(scene, cam, cfg)  # noqa: E731
    ms = {
        "forward render (kernel)": timed(fwd_render),
        "forward+backward step (kernels)": timed(step),
        "rk4_fwd call": timed(no_grad(lambda: cuda_kernel.rk4_fwd(
            *args, icfg.n_steps, 1.5))),
        "rk4_ckpt call": timed(no_grad(lambda: cuda_kernel.rk4_ckpt(
            *args, icfg.n_steps, seg, 1.5))),
    }
    with torch.no_grad():
        ck = cuda_kernel.rk4_ckpt(*args, icfg.n_steps, seg, 1.5)[-1]
    g = torch.ones_like(flat.x)
    bwd = no_grad(lambda: cuda_kernel.rk4_bwd(scal, ck, flat.E, g, g,
                                              icfg.n_steps, seg, 1.5))
    ms["rk4_bwd call"] = timed(bwd)
    ms["plain integrator, forward"] = once_ms(no_grad(
        lambda: cuda_kernel.integrate_plain(fenv, s0, icfg)))
    ms["forward render (plain)"] = once_ms(no_grad(
        lambda: P.render_image(scene, cam, cfg_plain)))
    ms["forward+backward step (plain)"] = once_ms(
        lambda: render_grads(scene, cam, cfg_plain))

    # the plain versions of rk4_ckpt and rk4_bwd: the checkpointed plain
    # loop's forward under autograd, and its backward
    def plain_forward():
        x = flat.x.detach().clone().requires_grad_(True)
        s = dataclasses.replace(flat, x=x)
        return cuda_kernel.integrate_plain(fenv, s, icfg).x.sum()

    ms["plain checkpointed loop, forward (rk4_ckpt's plain)"] = once_ms(
        plain_forward)
    ms["plain checkpointed loop, backward (rk4_bwd's plain)"] = \
        backward_ms(plain_forward)
    for what, v in ms.items():
        log(f"# phase 7: {what} {SIZE}x{SIZE}: median {v:.3f} ms, "
            f"{rays_n / (v * 1e-3):.4e} rays/s [{name_limit}]")
    ms_scal = timed(lambda: cuda_kernel._scalars(fenv, icfg, dev))
    dev_ms = {
        "rk4_fwd": device_ms(no_grad(
            lambda: cuda_kernel.rk4_fwd(*args, icfg.n_steps, 1.5))),
        "rk4_ckpt": device_ms(no_grad(
            lambda: cuda_kernel.rk4_ckpt(*args, icfg.n_steps, seg, 1.5))),
        "rk4_bwd": device_ms(bwd),
    }
    log(f"# phase 7: scalar vector {ms_scal:.3f} ms (host, median); device "
        "time (CUDA events, median of 10): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in dev_ms.items())
        + f" [{name_limit}]")

    # where the forward+backward step's device time goes: the device
    # kernels (and copies) the profiler records, by name
    step_profile(step, ms["forward+backward step (kernels)"],
                 "phase 7: forward+backward step", name_limit)

    readings["rk4_fwd"].update(ms=ms["rk4_fwd call"],
                               device_ms=dev_ms["rk4_fwd"],
                               plain_ms=ms["plain integrator, forward"])
    readings["rk4_ckpt"].update(
        ms=ms["rk4_ckpt call"], device_ms=dev_ms["rk4_ckpt"],
        plain_ms=ms["plain checkpointed loop, forward (rk4_ckpt's plain)"])
    readings["rk4_bwd"].update(
        ms=ms["rk4_bwd call"], device_ms=dev_ms["rk4_bwd"],
        plain_ms=ms["plain checkpointed loop, backward (rk4_bwd's plain)"])
    readings["step"] = {"fwd_bwd_ms": ms["forward+backward step (kernels)"],
                        "fwd_bwd_plain_ms":
                            ms["forward+backward step (plain)"],
                        "fwd_ms": ms["forward render (kernel)"]}


# =============================================================================
# The event variants: a z = 0 disk and spheres.
# =============================================================================
def bench_moons():
    """The four moons of bench.py's events scene (:132-136): centres at
    radius 7 and radii 0.6, 0.5, 0.7, 0.4."""
    ang = np.array([0.3, 1.9, 3.6, 5.2])
    centers = np.stack([7 * np.cos(ang), 7 * np.sin(ang),
                        0.8 * np.sin(2 * ang)], -1)
    return centers, [0.6, 0.5, 0.7, 0.4]


def events_fan(n, dev, seed=5):
    """n camera-style rays from z = 25, direction (0, 0, -1), through
    points spread evenly (seeded) over the circle of radius 9 that holds
    the disk and the moons of bench.py's events scene."""
    rng = np.random.default_rng(seed)
    r = 9.0 * np.sqrt(rng.random(n))
    ang = rng.uniform(0.0, 2 * np.pi, n)
    x0 = np.stack([r * np.cos(ang), r * np.sin(ang), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return f(x0), f(d0)


def with_events(env, centers=None, radii=None, disk=True):
    """``env`` with the events scene's disk (r_in 2, r_out 6) and spheres
    (bench.py's moons unless given)."""
    dev = env.mass.device
    if centers is None:
        centers, radii = bench_moons()
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa
                                  device=dev)
    return dataclasses.replace(
        env, disk=DiskGeom(r_in=f(2.0), r_out=f(6.0))
        if disk else None,
        spheres=SphereGeom(center=f(centers), radius=f(radii)))


def guard_stress(n, dev):
    """The Schwarzschild case of tests/test_pallas.py's sphere-guard stress
    test (:356-384), with ``n`` of its rays: spheres at the photon sphere
    and far out, its environment and step schedule."""
    rng = np.random.default_rng(7)
    x0 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                   np.full(n, 25.0)], -1)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -1.0)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    env = GeodesicEnv(mass=torch.tensor(0.5, device=dev),
                      r_capture=torch.tensor(1.0, device=dev),
                      r_escape=torch.tensor(60.0, device=dev),
                      lam_max=torch.tensor(60.0, device=dev))
    env = with_events(env, [[0.0, 2.6, 0.0], [0.0, 0.0, 30.0]], [0.7, 2.0],
                      disk=False)
    cfg = P.IntegratorConfig(n_steps=64, dt=0.1, dt_boost=64.0,
                             dt_boost_r_ref=1.7, dt_power=1.5)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return env, cfg, f(x0), f(d)


def long_step_spheres(env):
    """``env`` with the disk and eight spheres of radius 0.4 at z = 12..18,
    across events_fan's path, where the r^1.5 schedule makes a step 3-5 long:
    a ray enters a sphere with its step's end far outside the sphere's
    shell, so the guard's band must reach a whole step beyond it."""
    b = np.array([3.0, 5.0, 8.0, 11.0, 4.0, 6.5, 9.5, 2.8])
    ang = np.array([0.4, 2.0, 3.5, 5.0, 1.2, 2.8, 4.3, 5.8])
    z = np.array([12.0, 14.0, 16.0, 18.0, 13.0, 15.0, 17.0, 12.5])
    centers = np.stack([b * np.cos(ang), b * np.sin(ang), z], -1)
    return with_events(env, centers, [0.4] * 8)


def event_margin(env, cfg, s0):
    """Per ray, the least distance to an event's edge over the plain
    loop's steps from ``s0``: the distance of a segment's end from z = 0,
    of a crossing from r_in and r_out, of a segment's closest approach
    from a sphere's surface, of a sphere entry from the segment's ends, and
    between a disk crossing and a sphere entry on one segment."""
    inf = torch.full_like(s0.lam, float("inf"))
    margin, s = inf, s0
    with torch.no_grad():
        for _ in range(cfg.n_steps):
            act = s.active
            if not bool(act.any()):
                break
            dt = _dt_eff(env, cfg, s)
            y, _ = rk4_step(env, s.x, s.p, s.E, dt)
            x, D = s.x, y - s.x
            L = D.norm(dim=-1)
            m = inf
            t_disk = t_sph = inf
            if env.disk is not None:
                z0, z1 = x[..., 2], y[..., 2]
                m = torch.minimum(m, torch.minimum(z0.abs(), z1.abs()))
                t = -z0 / torch.where(D[..., 2] != 0, D[..., 2], 1.0)
                pt = x + D * t[..., None]
                rr = pt[..., :2].norm(dim=-1)
                edge = torch.minimum((rr - env.disk.r_in).abs(),
                                     (rr - env.disk.r_out).abs())
                m = torch.minimum(m, torch.where(z0 * z1 <= 0, edge, inf))
                t_disk, _ = _disk_event(env, x, y)
            if env.spheres is not None:
                aa = (D * D).sum(-1).clamp_min(1e-30)
                for c, r in zip(env.spheres.center, env.spheres.radius):
                    o = x - c
                    bb = 2.0 * (o * D).sum(-1)
                    cc = (o * o).sum(-1) - r * r
                    disc = bb * bb - 4.0 * aa * cc
                    tc = -bb / (2.0 * aa)        # closest approach
                    graze = (disc / (4.0 * aa)).abs() / (2.0 * r)
                    m = torch.minimum(m, torch.where((tc >= 0) & (tc <= 1),
                                                     graze, inf))
                    t = (-bb - disc.clamp_min(0).sqrt()) / (2.0 * aa)
                    ends = torch.minimum(t.abs(), (1.0 - t).abs()) * L
                    m = torch.minimum(m, torch.where(disc > 0, ends, inf))
                t_sph, _, _ = _sphere_events(env, x, y)
            if env.disk is not None and env.spheres is not None:
                both = torch.isfinite(t_disk) & torch.isfinite(t_sph)
                m = torch.minimum(m, torch.where(
                    both, (t_disk - t_sph).abs() * L, inf))
            margin = torch.where(act, torch.minimum(margin, m), margin)
            s = _fixed_step(env, cfg, s)
    return margin


def event_kappa(env, cfg, s0):
    """Per ray, the float32 conditioning of the event that ended it on the
    plain loop from ``s0`` (see KAPPA_CALM): L / |z1 - z0| for a disk
    crossing, |bb| / sqrt(disc) for a sphere entry, 1 for other rays."""
    kappa, s = torch.ones_like(s0.lam), s0
    with torch.no_grad():
        for _ in range(cfg.n_steps):
            act = s.active
            if not bool(act.any()):
                break
            y, _ = rk4_step(env, s.x, s.p, s.E, _dt_eff(env, cfg, s))
            D = y - s.x
            L = D.norm(dim=-1)
            s1 = _fixed_step(env, cfg, s)
            disk = act & (s1.status == states.DISK)
            kappa = torch.where(disk, L / D[..., 2].abs().clamp_min(1e-30),
                                kappa)
            obj = act & (s1.status == states.OBJECT)
            if bool(obj.any()):
                k = s1.hit_obj.clamp_min(0).long()
                o = s.x - env.spheres.center[k]
                r = env.spheres.radius[k]
                aa = (D * D).sum(-1)
                bb = 2.0 * (o * D).sum(-1)
                disc = bb * bb - 4.0 * aa * ((o * o).sum(-1) - r * r)
                kappa = torch.where(obj, bb.abs() / disc.clamp_min(1e-30)
                                    .sqrt(), kappa)
            s = s1
    return kappa


def split_edges(env, cfg, s0, a, b, what):
    """The rays whose status or hit id differs between the kernel state
    ``a`` and the plain state ``b``: each must touch an event's edge within
    EVENT_EPS, and at most MAX_EDGE of them.  Returns (the mask of the
    other rays, their count, the largest margin among them)."""
    flip = (a.status != b.status) | (a.hit_obj != b.hit_obj)
    n = int(flip.sum())
    worst = 0.0
    if n:
        if n > MAX_EDGE:
            raise AssertionError(f"{what}: {n} statuses or hit ids differ "
                                 f"(at most {MAX_EDGE} edge rays)")
        margin = event_margin(env, cfg, rays(s0, flip))
        worst = float(margin.max())
        if not worst <= EVENT_EPS:
            raise AssertionError(
                f"{what}: a ray whose status differs is {worst:.3e} from "
                f"any event's edge (limit {EVENT_EPS:g})")
    return ~flip, n, worst


def compare_events(env, cfg, s0, a, b, what, near=None):
    """compare_flagship for the event variant: statuses and hit ids equal
    apart from the edge rays of split_edges, which are counted, capped and
    left out; rays near b_c (or in ``near``) held to lam within half a
    step, the others to the state tolerances.  Returns (error, rays
    aligned a step apart, edge rays)."""
    keep, n_edge, worst = split_edges(env, cfg, s0, a, b, what)
    a, b, s0k = rays(a, keep), rays(b, keep), rays(s0, keep)
    err, n, _ = compare_flagship(env, cfg, s0k, a, b, what,
                                 None if near is None else near[keep])
    hist = torch.bincount(b.status.reshape(-1).long(), minlength=8).tolist()
    log(f"# events [{what}] {n_edge} edge rays left out (largest margin "
        f"{worst:.3e}); hit ids equal; DISK {hist[4]} OBJECT {hist[5]}")
    if not (hist[4] or hist[5]):
        raise AssertionError(f"{what}: no ray ended on the disk or a sphere")
    return err, n, n_edge


def golden_event_scenes(dev):
    """tests/test_golden.py's einstein_ring and disk_and_moons (:53-65)."""
    sky = torch.as_tensor(make_sky(32, 64, check=8), dtype=torch.float32,
                          device=dev)
    bh = P.BlackHole.make(mass=0.5, device=dev)
    moon = np.tile(np.float32([0.2, 1.0, 0.2]), (2, 8, 8, 1))
    yield "einstein_ring", (
        P.Scene(bh=bh, background=sky, spheres=P.Spheres.make(
            center=[[0.0, 0.0, -12.0]], radius=[1.0], texture=moon[:1],
            device=dev)),
        P.Camera.make(position=(0.0, 0.0, 20.0), fov=(0.9, 0.9), device=dev))
    yield "disk_and_moons", (
        P.Scene(bh=bh, background=sky,
                disk=P.Disk.make(r_in=2.0, r_out=6.0, device=dev,
                                 texture=np.tile(np.float32([1.0, 0.6, 0.2]),
                                                 (8, 32, 1))),
                spheres=P.Spheres.make(
                    center=[[6.0, 2.0, 6.0], [-5.0, -2.0, -8.0]],
                    radius=[0.8, 0.8], texture=moon, device=dev)),
        P.Camera.make(position=(0.0, 6.0, 19.0), euler=(-0.3, 0.0, 0.0),
                      fov=(0.9, 0.9), device=dev))


def event_batches(env, icfg, dev):
    """(label, environment, config, initial state) of the event phases."""
    on = lambda **kw: dataclasses.replace(icfg, **kw)  # noqa: E731
    eenv = with_events(env)
    out = [(f"events fan {FAN}", eenv, icfg,
            initial_state(eenv, *events_fan(FAN, dev)))]
    xr, dr = ragged_batch(1000, dev)
    out += [(f"events ragged 1000 power={pw}", eenv, on(dt_power=pw),
             initial_state(eenv, xr, dr)) for pw in POWERS]
    genv, gcfg, xg, dg = guard_stress(FAN, dev)
    out.append((f"guard stress {FAN}", genv, gcfg,
                initial_state(genv, xg, dg)))
    lenv = long_step_spheres(env)
    out.append((f"long-step spheres, fan {FAN}", lenv, icfg,
                initial_state(lenv, *events_fan(FAN, dev))))
    return out


def phase_events_fwd(env, icfg, dev, readings):
    """rk4_fwd's event variant against the plain loop on the card."""
    err, aligned, edges = 0.0, 0, 0
    for what, e, c, s0 in event_batches(env, icfg, dev):
        with torch.no_grad():
            sk = cuda_kernel.integrate_cuda(e, s0, c)
            sp = cuda_kernel.integrate_plain(e, s0, c)
        got = phase(f"phase 8 (rk4_fwd events vs plain, {what})",
                    compare_events, e, c, s0, sk, sp, what)
        if got is not None:
            err, aligned, edges = (max(err, got[0]), aligned + got[1],
                                   edges + got[2])
    for name, (scene, cam) in golden_event_scenes(dev):
        golden = np.load(ROOT / "tests" / "golden" / f"{name}.npz")
        ref = torch.as_tensor(golden["img"].astype(np.float32), device=dev)
        gcfg = P.RenderConfig(width=64, height=64, lam_max=120.0,
                              integrator=P.IntegratorConfig(n_steps=400,
                                                            dt=0.08))
        reset_counts()
        img = P.render_image(scene, cam, gcfg)
        check(read_counts() == only(rk4_fwd_events=1),
              f"golden {name} launched {read_counts()}")
        image_rule(img, ref, f"64x64 golden {name}, kernel", GOLDEN_MEAN,
                   GOLDEN_FRAC)
    readings["rk4_fwd_events"].update(max_abs_err=err, rays_aligned=aligned,
                                      edge_rays=edges)
    log("# phase 8: rk4_fwd's event variant agrees with plain PyTorch on "
        "the card")


def events_scene(dev, moon_tex=None, spin=None):
    """bench.py's make_scene('events', spin=spin) (:111-141) on ``dev``:
    the flagship sky, a z = 0 disk (r_in 2, r_out 6) with a 64x256 texture
    and the four moons, one colour unless ``moon_tex`` is given, around a
    hole of mass 0.5 and spin ``spin``."""
    v, u = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    disk_tex = np.stack([0.9 + 0 * u, 0.5 + 0.3 * np.sin(8 * np.pi * u / 256),
                         0.2 + 0 * u], -1)
    centers, radii = bench_moons()
    if moon_tex is None:
        moon_tex = np.tile(np.float32([0.3, 0.9, 0.4]), (4, 16, 32, 1))
    return P.Scene(
        bh=P.BlackHole.make(mass=0.5, spin=spin, device=dev),
        background=torch.as_tensor(make_sky(), dtype=torch.float32,
                                   device=dev),
        disk=P.Disk.make(r_in=2.0, r_out=6.0, texture=disk_tex, device=dev),
        spheres=P.Spheres.make(center=centers, radius=radii,
                               texture=moon_tex, device=dev))


def events_cam(dev):
    """bench.py's camera for the events rows (:1023-1027): (0, 0, 25),
    tilted by 0.25 rad about x, fov 0.8."""
    return P.Camera.make(position=(0.0, 0.0, 25.0), euler=(0.25, 0.0, 0.0),
                         fov=(0.8, 0.8), device=dev)


def varying_moons():
    """A moon texture that varies over the surface: the bench's is one
    colour, so its image does not depend on where a moon is hit and the
    gradient to a moon's centre and radius is zero."""
    v, u = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    tex = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * u / 32),
                    0.5 + 0.4 * np.cos(np.pi * v / 16), 0.5 + 0 * u], -1)
    return np.tile(tex.astype(np.float32), (4, 1, 1, 1))


def phase_events_ckpt(env, icfg, dev, readings):
    """rk4_ckpt's event variant against rk4_fwd's, and its checkpoint rows
    against the plain loop's states at the same steps."""
    cases = event_batches(env, icfg, dev)
    cfg = flagship_cfg()
    fenv, fs0 = flagship_rays(events_scene(dev), events_cam(dev), cfg, dev)
    cases.append((f"{SIZE}x{SIZE} events", fenv, cfg.integrator,
                  flat_state(fs0)))
    err, bitwise = ckpt_against_fwd(cases, "phase 9")
    readings["rk4_ckpt_events"].update(max_abs_err=err,
                                       equals_rk4_fwd=bitwise)


def ckpt_against_fwd(cases, tag):
    """For each (label, env, config, flat initial state): rk4_ckpt's final
    state equals rk4_fwd's bit for bit, and its checkpoint rows agree with
    the plain loop's states at the same steps (edge rays and rays a step
    apart left to the forward phase); with spheres, both kernels' outputs,
    checkpoints and live counts equal the NO_GUARD build's bit for bit.
    Returns (error, all bitwise)."""
    err, bitwise = 0.0, True
    for what, e, c, s0 in cases:
        with torch.no_grad():
            fwd, fin, ck = run_ckpt(e, c, s0)
            same = all(torch.equal(a, b) for a, b in zip(fwd, fin))
            bitwise &= same
            guard = ""
            if e.spheres is not None:
                with _build.built_with(*NO_GUARD):
                    witness = run_ckpt(e, c, s0)
                unguarded = all(
                    torch.equal(a, b) for a, b in zip(
                        (*fwd, *fin, *ck),
                        (*witness[0], *witness[1], *witness[2])))
                check(unguarded, f"{what}: rk4_fwd or rk4_ckpt differs from "
                      "its build without the sphere guard")
                guard = ("; both equal the build without the sphere guard"
                         if unguarded else "; DIFFER without the guard")
                del witness
            if not same:
                ray_diff = torch.zeros_like(fin[2], dtype=torch.bool)
                for a, b in zip(fwd, fin):
                    ne = a != b
                    ray_diff |= ne.reshape(ne.shape[0], -1).any(-1)
                k = ray_diff.nonzero()[:, 0]
                log(f"# {tag}: [{what}] {k.numel()} rays differ between "
                    f"rk4_ckpt and rk4_fwd: statuses {fin[3][k][:8].tolist()}"
                    f" vs {fwd[3][k][:8].tolist()}, max|dx| "
                    f"{float((fin[0] - fwd[0]).abs().max()):.3e}, max|dlam| "
                    f"{float((fin[2] - fwd[2]).abs().max()):.3e}")
            check(same, f"{what}: rk4_ckpt's final state differs from "
                  "rk4_fwd's")
            final = dataclasses.replace(s0, x=fin[0], p=fin[1], lam=fin[2],
                                        status=fin[3], hit_obj=fin[4])
            seg = cuda_kernel.segment(c.n_steps)
            plain, rows = cuda_kernel.integrate_ckpt_plain(e, s0, c, seg)
            # edge rays and rays a step apart (phase 8) are checked there
            keep = ((final.status == plain.status)
                    & (final.hit_obj == plain.hit_obj)
                    & ((final.lam - plain.lam).abs() <= TOL_X))
            for k, row in enumerate(rows):
                a, b = ckpt_rows(ck, k, s0), row
                label = f"{what}: checkpoint row {k} (step {k * seg})"
                err = max(err, compare_flagship(
                    e, c, rays(s0, keep), rays(a, keep), rays(b, keep),
                    label)[0])
        log(f"# {tag}: [{what}] rk4_ckpt "
            + ("equals rk4_fwd bit for bit" if same else "DIFFERS")
            + f"; {len(rows)} checkpoint rows of seg {seg} agree "
            f"({int((~keep).sum())} rays left to the forward phase); "
            + live_equal(ck, what) + guard)
    return err, bitwise


def event_grads(env, s0, cfg, loss_fn, kernel):
    """Cotangents of (x, p, E) of ``s0``, of the mass and of the (K, 4)
    sphere table [centre, radius], through the kernels or the plain loop."""
    mass = env.mass.detach().clone().requires_grad_(True)
    center = env.spheres.center.detach().clone().requires_grad_(True)
    radius = env.spheres.radius.detach().clone().requires_grad_(True)
    e = dataclasses.replace(env, mass=mass, spheres=SphereGeom(
        center=center, radius=radius))
    x, p, E = (t.detach().clone().requires_grad_(True)
               for t in (s0.x, s0.p, s0.E))
    s = dataclasses.replace(s0, x=x, p=p, E=E)
    out = (cuda_kernel.integrate_cuda(e, s, cfg) if kernel
           else cuda_kernel.integrate_plain(e, s, cfg))
    loss_fn(out).backward()
    sph = torch.cat([center.grad, radius.grad[:, None]], dim=1)
    return out, (x.grad, p.grad, E.grad, mass.grad, sph)


def phase_events_bwd(env, icfg, dev, readings):
    """rk4_bwd's event variant against autograd of the plain loop, the
    sphere cotangent included; edge rays get no weight in the loss."""
    rng = np.random.default_rng(2)
    eenv = with_events(env)
    xf, df = events_fan(FAN, dev)
    xr, dr = ragged_batch(1000, dev)
    cases = [(f"events fan {FAN}", (xf, df), icfg),
             (f"events fan {FAN}, 40 steps", (xf, df),
              dataclasses.replace(icfg, n_steps=40))]
    cases += [(f"events ragged 1000 power={pw}", (xr, dr),
               dataclasses.replace(icfg, dt_power=pw)) for pw in POWERS]
    err = 0.0
    for what, (x0, d0), c in cases:
        s0 = initial_state(eenv, x0, d0)
        with torch.no_grad():
            keep, n_edge, _ = split_edges(
                eenv, c, s0, cuda_kernel.integrate_cuda(eenv, s0, c),
                cuda_kernel.integrate_plain(eenv, s0, c), what)
            calm = keep & (event_kappa(eenv, c, s0) <= KAPPA_CALM)
        w = torch.as_tensor(rng.normal(size=tuple(x0.shape)),
                            dtype=torch.float32, device=dev)
        for part, mask, tol in (("all rays", keep, TOL_GRAD_EVENTS),
                                ("calm rays", calm, TOL_GRAD)):
            wx = w * mask[:, None]
            loss = lambda s: weighted_x_loss(s, wx)  # noqa: E731
            out_k, gk = event_grads(eenv, s0, c, loss, kernel=True)
            out_p, gp = event_grads(eenv, s0, c, loss, kernel=False)
            ok = (out_k.lam - out_p.lam).abs() <= TOL_X
            errs = [rel_err(a[ok], b[ok]) for a, b in zip(gk[:3], gp[:3])]
            dm = abs(float(gk[3]) / float(gp[3]) - 1.0)
            dsph = rel_err(gk[4], gp[4])
            active = int((out_k.status == states.ACTIVE).sum())
            log(f"# grad [{what}, {part}: {int(mask.sum())} weighted, "
                f"{n_edge} edge rays not, {active} ACTIVE at the end] x "
                f"{errs[0]:.3e} p {errs[1]:.3e} E {errs[2]:.3e} (max |d| / "
                f"max |plain|), mass rel {dm:.3e}, sphere cotangent (K, 4) "
                f"{dsph:.3e} (largest {float(gp[4].abs().max()):.4g})")
            check(max(errs) <= tol and dm <= max(tol, TOL_GRAD_MASS)
                  and dsph <= max(tol, TOL_GRAD_MASS),
                  f"{what}, {part}: cotangents outside {tol:g} (mass and "
                  f"spheres {max(tol, TOL_GRAD_MASS):g})")
            check(float(gp[4].abs().max()) > 0,
                  f"{what}: no sphere cotangent")
            err = max(err, *errs, dm, dsph)
        rk4_order_check(f"phase 10 [{what}]", eenv, c, s0, w, readings)
    # two runs of rk4_bwd give the same bits, the sphere cotangent included
    s0 = flat_state(initial_state(eenv, xf, df))
    g = torch.as_tensor(rng.normal(size=(2, FAN, 3)), dtype=torch.float32,
                        device=dev)
    kw = event_kw(eenv, s0)
    del kw["obj"]
    with torch.no_grad():
        _, _, ck = run_ckpt(eenv, icfg, s0)
        runs = [cuda_kernel.rk4_bwd(
            cuda_kernel._scalars(eenv, icfg, dev), ck, s0.E, g[0], g[1],
            icfg.n_steps, cuda_kernel.segment(icfg.n_steps), icfg.dt_power,
            **kw) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log("# determinism: two runs of rk4_bwd's event variant give "
        + ("bitwise-equal" if same else "DIFFERENT") + " outputs (sphere "
        f"cotangent of moon 0: {runs[0][4][0].tolist()})")
    check(same, "rk4_bwd's event variant is not deterministic")
    readings["rk4_bwd_events"]["max_abs_err"] = err
    log("# phase 10: rk4_bwd's event variant agrees with autograd of the "
        "plain loop")


def moon_grads(scene0, cam, cfg, moon=0):
    """d mean(img[..., :3]^2) / d (the centre and radius of one moon)."""
    center = scene0.spheres.center.detach().clone().requires_grad_(True)
    radius = scene0.spheres.radius.detach().clone().requires_grad_(True)
    scene = dataclasses.replace(scene0, spheres=dataclasses.replace(
        scene0.spheres, center=center, radius=radius))
    P.render_image(scene, cam, cfg)[..., :3].pow(2).mean().backward()
    return torch.cat([center.grad[moon], radius.grad[moon:moon + 1]])


def silhouettes(status, obj):
    """Pixels next to one whose status or hit id differs (the disk's and
    the moons' silhouettes, the shadow's edge)."""
    key = status * 8 + obj
    edge = torch.zeros_like(status, dtype=torch.bool)
    for dim in (0, 1):
        d = key.diff(dim=dim) != 0
        pad = [(0, 1), (1, 0)]
        for lo, hi in pad:
            shape = list(d.shape)
            shape[dim] = 1
            z = torch.zeros(shape, dtype=torch.bool, device=d.device)
            edge |= torch.cat([z, d] if lo else [d, z], dim=dim)
    return edge


def texel_cell(tex, u, v):
    """(row, column) of the texel cell a bilinear lookup of ``tex`` at bpy
    coords (u, v) falls in (texture._SampleBpy)."""
    h, w = tex.shape[:2]
    return (torch.floor((1.0 - v) * 0.5 * h - 0.5),
            torch.floor((u + 1.0) * 0.5 * w - 0.5))


def texel_flips(scene, a, end_a, b, end_b):
    """Sky and disk rays whose texture lookup falls in another texel cell
    in the final state ``a`` (end direction ``end_a``) than in ``b``."""
    def cells(s, end):
        sky = texel_cell(scene.background, *equirect_uv(end))
        if scene.disk is None:
            return sky
        disk = texel_cell(scene.disk.texture, *disk_uv(scene.disk, s.x))
        on_disk = s.status == states.DISK
        return [torch.where(on_disk, d, k) for d, k in zip(disk, sky)]

    (ra, ca), (rb, cb) = cells(a, end_a), cells(b, end_b)
    shaded = ((b.status == states.DISK) | (b.status == states.ESCAPED)
              | (b.status == states.BUDGET))
    return shaded & ((ra != rb) | (ca != cb))


def frame_parts(scene, fenv, icfg, s0, s, sp):
    """The ill-conditioned parts of a frame's gradient, as (H, W) masks by
    name -- near b_c, near the sky's pole, on the disk texture's seam, the
    silhouettes, after an ill-conditioned event -- and its texel flips,
    from the initial state ``s0``, the kernel's final state ``s`` and the
    plain loop's ``sp``."""
    with torch.no_grad():
        end = final_direction(fenv, sp)
        kappa = event_kappa(fenv, icfg, flat_state(s0)).reshape(
            sp.status.shape)
        flips = texel_flips(scene, s, final_direction(fenv, s), sp, end)
    rho = end[..., :2].norm(dim=-1)
    # the disk texture's azimuth arccos(x / R) sign(y) has a derivative
    # ~ 1 / |y| near the x axis, as the sky's at its pole
    seam = ((sp.status == states.DISK)
            & (sp.x[..., 1].abs() < POLE_RHO * sp.x[..., :2].norm(dim=-1)))
    return {"near b_c": near_b_c(fenv, s0), "near the pole": rho < POLE_RHO,
            "on the disk texture's seam": seam,
            "silhouettes": silhouettes(sp.status, sp.hit_obj),
            "ill-conditioned events": kappa > KAPPA_CALM}, flips


def variant(spin):
    """(kernel name suffix, label) of the Schwarzschild event variants or,
    with a spin, of the Kerr variants."""
    return (("_events", "events") if spin is None
            else ("_kerr_events", "Kerr events"))


def phase_events_render(dev, readings, spin=None):
    """bench.py's events frame at SIZE^2, forward and forward+backward,
    around a Schwarzschild hole or, with ``spin``, its kerr-events row
    (bench.py:1032-1038): the Kerr variants alone, the gradient to the
    spin too, and two runs of rk4_bwd's Kerr variant on the frame's rays
    bit for bit."""
    suffix, label = variant(spin)
    fwd_k, ckpt_k, bwd_k = (f"rk4_{k}{suffix}" for k in ("fwd", "ckpt", "bwd"))
    scene, cam = events_scene(dev, spin=spin), events_cam(dev)
    cfg, cfg_plain = flagship_cfg(), flagship_cfg(backend="torch")
    reset_counts()
    img = P.render_image(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    readings[fwd_k]["launches"] = launches.get(fwd_k, 0)
    check(launches == only(**{fwd_k: 1}),
          f"{label} render launched {launches}, expected {fwd_k} once")
    if img.shape != (SIZE, SIZE, 4) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label} image is not a finite {SIZE}x{SIZE}x4")
    with torch.no_grad():
        img_plain = P.render_image(scene, cam, cfg_plain)
    image_rule(img, img_plain, f"{SIZE}x{SIZE} {label}, kernel vs plain",
               FLAGSHIP_MEAN, FLAGSHIP_FRAC)
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    with torch.no_grad():
        s = cuda_kernel.integrate_cuda(fenv, s0, cfg.integrator)
        sp = cuda_kernel.integrate_plain(fenv, s0, cfg.integrator)
        e, n, n_edge = compare_events(
            fenv, cfg.integrator, flat_state(s0), flat_state(s),
            flat_state(sp), f"{SIZE}x{SIZE} {label}")
    r = readings[fwd_k]
    r.update(max_abs_err=max(r.get("max_abs_err", 0.0), e),
             rays_aligned=r.get("rays_aligned", 0) + n,
             edge_rays=r.get("edge_rays", 0) + n_edge)
    hist = torch.bincount(s.status.reshape(-1).long(), minlength=8).tolist()
    names = ("ACTIVE", "CAPTURED", "ESCAPED", "BUDGET", "DISK", "OBJECT",
             "INSIDE_HORIZON", "ERROR")
    log(f"# {label} {SIZE}x{SIZE} rendered through {fwd_k}; statuses "
        + " ".join(f"{k}={v}" for k, v in zip(names, hist) if v))

    # forward+backward: the gradient to the mass, the camera and the sky
    # (and the spin)
    reset_counts()
    gk = render_grads(scene, cam, cfg)
    torch.cuda.synchronize()
    launches, shaded = read_counts(), read_shading()
    for name in (ckpt_k, bwd_k):
        readings[name]["launches"] = launches.get(name, 0)
    check(launches == only(**{ckpt_k: 1, bwd_k: 1})
          and shaded == shading(spin is not None, fwd=1, bwd=1, tex=1),
          f"{label} forward+backward launched {launches}, {shaded}, "
          f"expected {ckpt_k} and {bwd_k} once each, the shading's forward "
          "and backward once each and its texture scatter once (the sky)")
    for g in gk:
        check(bool(torch.isfinite(g).all()), f"{label} gradient not finite")
    gp = render_grads(scene, cam, cfg_plain)
    # The whole frame's mass, camera (and spin) gradients are sums of large
    # parts of both signs, and float32 alone moves them by as much as they
    # are (the one-ulp reading below): they are readings, and the well-
    # conditioned part of the frame is held instead.  The sky gradient is
    # per texel and held whole.
    errs = compare_render_grads(gk, gp, f"{SIZE}x{SIZE} {label}, kernel vs "
                                "plain (mass, camera, spin: a reading)",
                                float("inf"))
    check(errs[2] <= TOL_EVENTS_GRAD,
          f"{label} sky gradient outside {TOL_EVENTS_GRAD:g}")
    # its float32 conditioning: the plain path with the camera one ulp away
    cam_ulp = dataclasses.replace(cam, position=cam.position.clone())
    cam_ulp.position[2] = torch.nextafter(cam.position[2],
                                          cam.position[2] + 1)
    compare_render_grads(render_grads(scene, cam_ulp, cfg_plain), gp,
                         f"{SIZE}x{SIZE} {label}, plain vs plain with the "
                         "camera one ulp away (a reading)", float("inf"))
    # the parts of the frame: near b_c, near the sky's pole, on a
    # silhouette, after an ill-conditioned event, texel flips, and the calm
    # rest
    parts, flips = frame_parts(scene, fenv, cfg.integrator, s0, s, sp)
    calm = torch.ones_like(flips)
    for m in parts.values():
        calm &= ~m
    n_flips = int((calm & flips).sum())
    check(n_flips <= MAX_TEXEL_FLIPS,
          f"{SIZE}x{SIZE} {label}: {n_flips} texel flips among the calm "
          f"pixels (at most {MAX_TEXEL_FLIPS})")
    parts["texel flips"] = flips
    calm &= ~flips
    for name, m in parts.items():
        gm = render_grads(scene, cam, cfg, m.float())
        log(f"# grad [{SIZE}x{SIZE} {label}] {int(m.sum())} pixels "
            f"{name} carry mass {float(gm[0]):.5g} and camera "
            f"{gm[1].tolist()} of the kernel path's mass {float(gk[0]):.5g} "
            f"and camera {gk[1].tolist()}")
    log(f"# grad [{SIZE}x{SIZE} {label}] calm pixels {int(calm.sum())} "
        f"({n_flips} texel flips left out)")
    gp_calm = render_grads(scene, cam, cfg_plain, calm.float())
    calm_errs = compare_render_grads(
        render_grads(scene, cam, cfg, calm.float()), gp_calm,
        f"{SIZE}x{SIZE} {label}, calm pixels, kernel vs plain",
        TOL_CALM_GRAD)
    compare_render_grads(render_grads(scene, cam_ulp, cfg_plain, calm.float()),
                         gp_calm, f"{SIZE}x{SIZE} {label}, calm pixels, plain "
                         "vs plain with the camera one ulp away (a reading)",
                         float("inf"))
    held = [errs[2]] + calm_errs
    if spin is None:
        # a second gradient: one moon's centre and radius, with a texture
        # that varies over the moons' surfaces
        mscene = events_scene(dev, varying_moons())
        mk = moon_grads(mscene, cam, cfg)
        mp = moon_grads(mscene, cam, cfg_plain)
        dm = rel_err(mk, mp)
        log(f"# grad [{SIZE}x{SIZE} events, moon 0 centre and radius] "
            f"{mk.tolist()} vs {mp.tolist()} ({dm:.3e})")
        check(dm <= TOL_MOON_GRAD and float(mp.abs().max()) > 0,
              f"moon gradient outside {TOL_MOON_GRAD:g}")
        held.append(dm)
    else:
        # two runs of rk4_bwd's Kerr variant on the frame's rays, and two
        # whole gradients
        flat, icfg = flat_state(s0), cfg.integrator
        rng = np.random.default_rng(3)
        gx, gpp = (torch.as_tensor(rng.normal(size=(SIZE * SIZE, 3)),
                                   dtype=torch.float32, device=dev)
                   for _ in range(2))
        kw = event_kw(fenv, flat)
        with torch.no_grad():
            _, _, ck = run_ckpt(fenv, icfg, flat)
            del kw["obj"]
            runs = [cuda_kernel.rk4_bwd(
                cuda_kernel._scalars(fenv, icfg, dev), ck, flat.E, gx, gpp,
                icfg.n_steps, cuda_kernel.segment(icfg.n_steps),
                icfg.dt_power, **kw) for _ in range(2)]
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        gk2 = render_grads(scene, cam, cfg)
        log(f"# determinism: two runs of {bwd_k} on the {SIZE}x{SIZE} "
            f"{label} rays give "
            + ("bitwise-equal" if same else "DIFFERENT") + " outputs (spin "
            f"cotangent {float(runs[0][3][adjoint.SPIN]):.9g}); two "
            "whole gradients are "
            + ("equal" if all(torch.equal(a, b) for a, b in zip(gk, gk2))
               else "not equal") + " bit for bit")
        check(same, f"{bwd_k} is not deterministic")
    readings[bwd_k].update(render_grad_err=max(held), texel_flips=n_flips)
    log(f"# {label} forward+backward through {ckpt_k} and {bwd_k} agrees "
        "with the plain path")


def phase_events_times(dev, name_limit, readings, spin=None):
    suffix, label = variant(spin)
    scene, cam = events_scene(dev, spin=spin), events_cam(dev)
    cfg, cfg_plain = flagship_cfg(), flagship_cfg(backend="torch")
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    icfg = cfg.integrator
    flat = flat_state(s0)
    scal = cuda_kernel._scalars(fenv, icfg, dev)
    seg = cuda_kernel.segment(icfg.n_steps)
    kw = event_kw(fenv, flat)
    args = (scal, flat.x, flat.p, flat.E, flat.lam, flat.status)

    fwd = no_grad(lambda: cuda_kernel.rk4_fwd(*args, icfg.n_steps, 1.5, **kw))
    ckpt = no_grad(lambda: cuda_kernel.rk4_ckpt(*args, icfg.n_steps, seg,
                                                1.5, **kw))
    ck = ckpt()[-1]
    g = torch.ones_like(flat.x)
    bwd = no_grad(lambda: cuda_kernel.rk4_bwd(
        scal, ck, flat.E, g, g, icfg.n_steps, seg, 1.5, sph=kw["sph"],
        has_disk=True, kerr=kw["kerr"]))
    step = lambda: render_grads(scene, cam, cfg)  # noqa: E731

    def plain_forward():
        x = flat.x.detach().clone().requires_grad_(True)
        s = dataclasses.replace(flat, x=x)
        return cuda_kernel.integrate_plain(fenv, s, icfg).x.sum()

    names = {k: f"rk4_{k}{suffix}" for k in ("fwd", "ckpt", "bwd")}
    ms = {
        f"{label} forward render (kernel)": timed(no_grad(
            lambda: P.render_image(scene, cam, cfg))),
        f"{label} forward+backward step (kernels)": timed(step),
        f"{names['fwd']} call": timed(fwd),
        f"{names['ckpt']} call": timed(ckpt),
        f"{names['bwd']} call": timed(bwd),
        f"{label} plain integrator, forward": once_ms(no_grad(
            lambda: cuda_kernel.integrate_plain(fenv, s0, icfg))),
        f"{label} forward render (plain)": once_ms(no_grad(
            lambda: P.render_image(scene, cam, cfg_plain))),
        f"{label} forward+backward step (plain)": once_ms(
            lambda: render_grads(scene, cam, cfg_plain)),
        f"{label} plain checkpointed loop, forward": once_ms(plain_forward),
        f"{label} plain checkpointed loop, backward": backward_ms(
            plain_forward),
    }
    tag = "phase 12" if spin is None else "phase 17"
    for what, v in ms.items():
        log(f"# {tag}: {what} {SIZE}x{SIZE}: median {v:.3f} ms, "
            f"{SIZE * SIZE / (v * 1e-3):.4e} rays/s [{name_limit}]")
    dev_ms = {names["fwd"]: device_ms(fwd), names["ckpt"]: device_ms(ckpt),
              names["bwd"]: device_ms(bwd)}
    log(f"# {tag}: device time (CUDA events, median of 10): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in dev_ms.items())
        + f" [{name_limit}]")
    wall = ms[f"{label} forward+backward step (kernels)"]
    step_profile(step, wall, f"{tag}: {label} forward+backward step",
                 name_limit)
    for k, plain in (("fwd", "plain integrator, forward"),
                     ("ckpt", "plain checkpointed loop, forward"),
                     ("bwd", "plain checkpointed loop, backward")):
        name = names[k]
        readings[name].update(ms=ms[f"{name} call"], device_ms=dev_ms[name],
                              plain_ms=ms[f"{label} {plain}"])
    readings[f"step{suffix}"] = {
        "fwd_bwd_ms": wall,
        "fwd_bwd_plain_ms": ms[f"{label} forward+backward step (plain)"],
        "fwd_ms": ms[f"{label} forward render (kernel)"]}


# =============================================================================
# The Kerr variants.
# =============================================================================
def kerr_env(spin, dev, r_escape=70.0, lam_max=100.0):
    """A hole of mass 0.5 and spin ``spin`` that captures at its outer
    horizon r_+, as render/renderer.py's scene_env sets it."""
    mass = torch.tensor(0.5, device=dev)
    a = torch.tensor(spin, device=dev)
    return GeodesicEnv(mass=mass, spin=a, r_capture=horizon_radius(mass, a),
                       r_escape=torch.tensor(r_escape, device=dev),
                       lam_max=torch.tensor(lam_max, device=dev))


def kerr_gap(env):
    """The impact parameters a Kerr fan leaves out: within KERR_BAND of the
    critical sky radius of its rays (L_z = 0; photon_band)."""
    m = float(env.mass)
    rho_c = photon_band(m, float(env.spin))[0]
    return rho_c - KERR_BAND * m, rho_c + KERR_BAND * m


def kerr_guard_stress(spin, n, dev):
    """A Kerr sphere-guard stress batch: six spheres of radius 0.35 at
    radius 2 in the equatorial plane (inner edges at 1.65), rays from radii
    1.45-1.6 near that plane heading outwards, steps of 0.01 in the strong
    field.  A ray enters a sphere near its inner edge with a step far
    shorter than |y| - r_KS(y) (about a^2 / 2r there), so a guard band
    without its |a| of slack skips the entry: tests/test_pallas.py's Kerr
    stress case (:366) has steps too long to show it."""
    rng = np.random.default_rng(11)
    ang = np.linspace(0.0, 2 * np.pi, 6, endpoint=False) + 0.3
    centers = np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang), np.zeros(6)],
                       -1)
    env = with_events(kerr_env(spin, dev, r_escape=60.0, lam_max=60.0),
                      centers, [0.35] * 6, disk=False)
    r = rng.uniform(1.45, 1.6, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)
    x0 = np.stack([r * np.cos(ph), r * np.sin(ph),
                   rng.uniform(-0.25, 0.25, n)], -1)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d += 2.0 * x0 / np.linalg.norm(x0, axis=-1, keepdims=True)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cfg = P.IntegratorConfig(n_steps=200, dt=0.01, dt_boost=64.0,
                             dt_boost_r_ref=1.7, dt_power=1.5)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return env, cfg, f(x0), f(d)


def kerr_batches(spin, icfg, dev):
    """(label, environment, config, initial state, with events) of the Kerr
    phases for one spin: the fan and the ragged batch with the band around
    the critical sky radius left out, the events fan over the disk and the
    moons, and the guard-stress batch."""
    env = kerr_env(spin, dev)
    gap = kerr_gap(env)
    tag = f"Kerr a={spin:g}"
    out = [(f"{tag} fan {FAN}", env, icfg,
            initial_state(env, *camera_fan(FAN, dev, gap)), False)]
    xr, dr = ragged_batch(1000, dev, gap=gap)
    out += [(f"{tag} ragged 1000 power={pw}", env,
             dataclasses.replace(icfg, dt_power=pw),
             initial_state(env, xr, dr), False) for pw in POWERS]
    eenv = with_events(env)
    out.append((f"{tag} events fan {FAN}", eenv, icfg,
                initial_state(eenv, *events_fan(FAN, dev)), True))
    genv, gcfg, xg, dg = kerr_guard_stress(spin, FAN, dev)
    out.append((f"{tag} guard stress {FAN}", genv, gcfg,
                initial_state(genv, xg, dg), True))
    return out


def phase_kerr_fwd(icfg, dev, readings):
    """rk4_fwd's Kerr variants against the plain Kerr loop on the card, at
    a = 0.45 and a = -0.3, and the kerr_a09 golden through them."""
    # (error, rays aligned, edge rays) of each variant
    got_by = {False: [0.0, 0, 0], True: [0.0, 0, 0]}
    for spin in SPINS:
        for what, e, c, s0, events in kerr_batches(spin, icfg, dev):
            with torch.no_grad():
                sk = cuda_kernel.integrate_cuda(e, s0, c)
                sp = cuda_kernel.integrate_plain(e, s0, c)
            if events:
                got = phase(f"phase 13 ({what})", compare_events, e, c, s0,
                            sk, sp, what)
            else:
                got = phase(f"phase 13 ({what})", compare_states, e, c, sk,
                            sp, what)
                inside = sk.status == states.INSIDE_HORIZON
                if "ragged" in what and not torch.equal(sk.x[inside],
                                                        s0.x[inside]):
                    check(False, f"{what}: inside-horizon rays moved")
            if got is not None:
                acc = got_by[events]
                acc[0], acc[1] = max(acc[0], got[0]), acc[1] + got[1]
                acc[2] += got[2] if events else 0
    # tests/test_golden.py's kerr_a09 (:66-72)
    golden = np.load(ROOT / "tests" / "golden" / "kerr_a09.npz")
    ref = torch.as_tensor(golden["img"].astype(np.float32), device=dev)
    sky = torch.as_tensor(make_sky(32, 64, check=8), dtype=torch.float32,
                          device=dev)
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, spin=0.45, device=dev),
                    background=sky)
    cam = P.Camera.make(position=(20.0, 0.0, 0.0), euler=(0.0, np.pi / 2, 0.0),
                        fov=(0.7, 0.7), device=dev)
    gcfg = P.RenderConfig(width=64, height=64, lam_max=120.0,
                          integrator=P.IntegratorConfig(n_steps=400, dt=0.08))
    reset_counts()
    img = P.render_image(scene, cam, gcfg)
    check(read_counts() == only(rk4_fwd_kerr=1),
          f"golden kerr_a09 launched {read_counts()}")
    image_rule(img, ref, "64x64 golden kerr_a09, kernel", GOLDEN_MEAN,
               GOLDEN_FRAC)
    for events, (err, aligned, edges) in got_by.items():
        readings["rk4_fwd_kerr" + ("_events" if events else "")].update(
            max_abs_err=err, rays_aligned=aligned, edge_rays=edges)
    log("# phase 13: rk4_fwd's Kerr variants agree with the plain Kerr loop "
        "on the card")


def phase_kerr_ckpt(icfg, dev, readings):
    """rk4_ckpt's Kerr variants against rk4_fwd's (bit for bit) and their
    checkpoint rows against the plain Kerr loop, on the Kerr batches and
    the rays of the 1024^2 kerr-events frame."""
    cases = {False: [], True: []}
    for spin in SPINS:
        for what, e, c, s0, events in kerr_batches(spin, icfg, dev):
            cases[events].append((what, e, c, flat_state(s0)))
    cfg = flagship_cfg()
    fenv, fs0 = flagship_rays(events_scene(dev, spin=0.45), events_cam(dev),
                              cfg, dev)
    cases[True].append((f"{SIZE}x{SIZE} Kerr events", fenv, cfg.integrator,
                        flat_state(fs0)))
    for events, batch in cases.items():
        err, bitwise = ckpt_against_fwd(batch, "phase 14")
        readings["rk4_ckpt_kerr" + ("_events" if events else "")].update(
            max_abs_err=err, equals_rk4_fwd=bitwise)


def kerr_grads(env, s0, cfg, loss_fn, kernel):
    """Cotangents of (x, p, E) of ``s0``, of the mass, of the spin and, with
    spheres, of the (K, 4) sphere table, through the kernels or the plain
    loop."""
    leaf = lambda t: t.detach().clone().requires_grad_(True)  # noqa: E731
    e = dataclasses.replace(env, mass=leaf(env.mass), spin=leaf(env.spin))
    if env.spheres is not None:
        e.spheres = SphereGeom(center=leaf(env.spheres.center),
                               radius=leaf(env.spheres.radius))
    x, p, E = (leaf(t) for t in (s0.x, s0.p, s0.E))
    s = dataclasses.replace(s0, x=x, p=p, E=E)
    out = (cuda_kernel.integrate_cuda(e, s, cfg) if kernel
           else cuda_kernel.integrate_plain(e, s, cfg))
    loss_fn(out).backward()
    sph = (None if env.spheres is None else
           torch.cat([e.spheres.center.grad, e.spheres.radius.grad[:, None]],
                     dim=1))
    return out, (x.grad, p.grad, E.grad, e.mass.grad, e.spin.grad, sph)


def spin_aligned(env, s0, cfg, w):
    """``w`` (n, 3) with each ray's sign chosen so that its term of the
    spin cotangent of weighted_x_loss is >= 0 on the plain loop (the plain
    loop run with a spin per ray).  With random signs the rays' terms
    cancel to about 1/70 of their absolute sum (the 40-step Kerr fan), so
    their total would read the float32 rounding of a few strong-field rays
    rather than the kernel; aligned, the total is that absolute sum."""
    a = torch.full_like(s0.E, float(env.spin)).requires_grad_(True)
    out = cuda_kernel.integrate_plain(dataclasses.replace(env, spin=a), s0,
                                      cfg)
    weighted_x_loss(out, w).backward()
    return w * torch.where(a.grad < 0, -1.0, 1.0)[:, None]


def phase_kerr_bwd(icfg, dev, readings):
    """rk4_bwd's Kerr variants against autograd of the plain Kerr loop: the
    per-ray cotangents of x, p and E, and those of the mass, the spin and,
    with events, the spheres; edge rays get no weight in the loss, and the
    weights' signs follow each ray's spin term (spin_aligned)."""
    rng = np.random.default_rng(2)
    cases = []
    for spin, cuts in ((0.45, (100, 40)), (-0.3, (40,))):
        env = kerr_env(spin, dev)
        xf, df = camera_fan(FAN, dev, kerr_gap(env))
        cases += [(f"Kerr a={spin:g} fan {FAN}, {n} steps", env, (xf, df),
                   dataclasses.replace(icfg, n_steps=n)) for n in cuts]
        if spin == 0.45:
            xr, dr = ragged_batch(1000, dev, gap=kerr_gap(env))
            cases += [(f"Kerr a=0.45 ragged 1000 power={pw}", env, (xr, dr),
                       dataclasses.replace(icfg, dt_power=pw))
                      for pw in POWERS]
        cases.append((f"Kerr a={spin:g} events fan {FAN}", with_events(env),
                      events_fan(FAN, dev), icfg))
    err = {False: 0.0, True: 0.0}   # of each variant
    for what, env, (x0, d0), c in cases:
        s0 = initial_state(env, x0, d0)
        events = env.disk is not None
        parts = [("all rays", torch.ones_like(s0.lam, dtype=torch.bool),
                  TOL_GRAD)]
        n_edge = 0
        if events:
            with torch.no_grad():
                keep, n_edge, _ = split_edges(
                    env, c, s0, cuda_kernel.integrate_cuda(env, s0, c),
                    cuda_kernel.integrate_plain(env, s0, c), what)
                calm = keep & (event_kappa(env, c, s0) <= KAPPA_CALM)
            parts = [("all rays", keep, TOL_GRAD_EVENTS),
                     ("calm rays", calm, TOL_GRAD)]
        w = spin_aligned(env, s0, c, torch.as_tensor(
            rng.normal(size=tuple(x0.shape)), dtype=torch.float32,
            device=dev))
        for part, mask, tol in parts:
            wx = w * mask[:, None]
            loss = lambda s: weighted_x_loss(s, wx)  # noqa: E731
            out_k, gk = kerr_grads(env, s0, c, loss, kernel=True)
            out_p, gp = kerr_grads(env, s0, c, loss, kernel=False)
            ok = (out_k.lam - out_p.lam).abs() <= TOL_X
            errs = [rel_err(a[ok], b[ok]) for a, b in zip(gk[:3], gp[:3])]
            dm = abs(float(gk[3]) / float(gp[3]) - 1.0)
            ds = abs(float(gk[4]) / float(gp[4]) - 1.0)
            dsph = rel_err(gk[5], gp[5]) if events else 0.0
            active = int((out_k.status == states.ACTIVE).sum())
            log(f"# grad [{what}, {part}: {int(mask.sum())} weighted, "
                f"{n_edge} edge rays not, {active} ACTIVE at the end] x "
                f"{errs[0]:.3e} p {errs[1]:.3e} E {errs[2]:.3e} (max |d| / "
                f"max |plain|), mass {float(gk[3]):.7g} vs {float(gp[3]):.7g}"
                f" (rel {dm:.3e}), spin {float(gk[4]):.7g} vs "
                f"{float(gp[4]):.7g} (rel {ds:.3e})"
                + (f", spheres (K, 4) {dsph:.3e}" if events else ""))
            lim = max(tol, TOL_GRAD_MASS)
            check(max(errs) <= tol and dm <= lim and ds <= lim
                  and dsph <= lim,
                  f"{what}, {part}: cotangents outside {tol:g} (mass, spin "
                  f"and spheres {lim:g})")
            check(float(gp[4].abs()) > 0, f"{what}: no spin cotangent")
            err[events] = max(err[events], *errs, dm, ds, dsph)
        rk4_order_check(f"phase 15 [{what}]", env, c, s0, w, readings)
    # two runs of rk4_bwd's Kerr variant give the same bits
    env = with_events(kerr_env(0.45, dev))
    s0 = flat_state(initial_state(env, *events_fan(FAN, dev)))
    g = torch.as_tensor(rng.normal(size=(2, FAN, 3)), dtype=torch.float32,
                        device=dev)
    kw = event_kw(env, s0)
    del kw["obj"]
    with torch.no_grad():
        _, _, ck = run_ckpt(env, icfg, s0)
        runs = [cuda_kernel.rk4_bwd(
            cuda_kernel._scalars(env, icfg, dev), ck, s0.E, g[0], g[1],
            icfg.n_steps, cuda_kernel.segment(icfg.n_steps), icfg.dt_power,
            **kw) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log("# determinism: two runs of rk4_bwd's Kerr variant give "
        + ("bitwise-equal" if same else "DIFFERENT") + " outputs")
    check(same, "rk4_bwd's Kerr variant is not deterministic")
    for events, e in err.items():
        readings["rk4_bwd_kerr" + ("_events" if events else "")][
            "max_abs_err"] = e
    log("# phase 15: rk4_bwd's Kerr variants agree with autograd of the "
        "plain Kerr loop")


def kerr_fan(dev):
    """bench.py's bench_integrator(spin=0.45) (:409-440): a hole of mass
    0.5 and spin 0.45 that captures at r = 1, its schedule and its 1M-ray
    camera fan (initial positions and directions)."""
    env = GeodesicEnv(mass=torch.tensor(0.5, device=dev),
                      r_capture=torch.tensor(1.0, device=dev),
                      r_escape=torch.tensor(70.0, device=dev),
                      lam_max=torch.tensor(100.0, device=dev),
                      spin=torch.tensor(0.45, device=dev))
    cfg = P.IntegratorConfig(n_steps=100, dt=0.12, dt_boost=64.0,
                             dt_boost_r_ref=1.7, dt_power=1.5)
    return env, cfg, *camera_fan(INTEGRATOR_RAYS, dev)


def near_kink(env, cfg, s0):
    """Per ray, whether on some step of the plain loop from ``s0`` its
    radius lies within TOL_X (the paths' x agree to it) of a clip edge of
    the step schedule: ratio 1 at r_ref and ratio dt_boost at r_ref
    dt_boost^(1 / dt_power), 27.2 for the flagship's.  There the step
    size's derivative jumps, and two correct float32 paths on either side
    take its two one-sided derivatives (a kink flip; float64 parts from
    both by as much)."""
    r_ref = float(cfg.dt_boost_r_ref or 6.0 * float(env.mass))
    kinks = (r_ref, r_ref * cfg.dt_boost ** (1.0 / cfg.dt_power))
    hit = torch.zeros_like(s0.lam, dtype=torch.bool)
    s = s0
    with torch.no_grad():
        for _ in range(cfg.n_steps):
            act = s.active
            if not bool(act.any()):
                break
            r = env.radius(s.x)
            for k in kinks:
                hit |= act & ((r - k).abs() <= TOL_X)
            s = _fixed_step(env, cfg, s)
    return hit


def phase_kerr_integrator(dev, name_limit, readings):
    """bench.py's bench_integrator(spin=0.45): the integrator alone on its
    1M-ray camera fan, forward and the gradient of sum(x^2) 1e-6 to the
    mass, through the Kerr variants without events (launches checked),
    against the plain loop: the loss's mass gradient, each ray's final
    state (compare_flagship: the fan's inner band ends 0.008 from the
    critical 2.458), rk4_ckpt's final states against rk4_fwd's bit for bit
    and its checkpoint rows, and rk4_bwd's per-ray cotangents away from b_c
    and from the step schedule's kinks (near_kink) for a loss smooth in the
    final state; then times."""
    env, cfg, x0, d0 = kerr_fan(dev)
    n = INTEGRATOR_RAYS

    def loss(mass, backend):
        s = P.launch(dataclasses.replace(env, mass=mass), x0, d0,
                     dataclasses.replace(cfg, backend=backend))
        return (s.x ** 2).sum() * 1e-6

    def forward(backend):
        with torch.no_grad():
            return loss(torch.tensor(0.5, device=dev), backend)

    def gradient(backend):
        mass = torch.tensor(0.5, device=dev, requires_grad=True)
        loss(mass, backend).backward()
        return mass.grad

    # the main path: bench.py's kerr row, forward and gradient
    reset_counts()
    lk = forward("auto")
    launches = read_counts()
    readings["rk4_fwd_kerr"]["launches"] = launches.get("rk4_fwd_kerr", 0)
    check(launches == only(rk4_fwd_kerr=1),
          f"Kerr integrator forward launched {launches}")
    reset_counts()
    gk = gradient("auto")
    launches = read_counts()
    for name in ("rk4_ckpt_kerr", "rk4_bwd_kerr"):
        readings[name]["launches"] = launches.get(name, 0)
    check(launches == only(rk4_ckpt_kerr=1, rk4_bwd_kerr=1),
          f"Kerr integrator gradient launched {launches}")
    lp, gp = forward("torch"), gradient("torch")
    dm = abs(float(gk) / float(gp) - 1)
    log(f"# phase 18: Kerr integrator {n} rays: loss {float(lk):.7g} vs "
        f"plain {float(lp):.7g} (rel {abs(float(lk) / float(lp) - 1):.3e}),"
        f" d/dmass {float(gk):.7g} vs {float(gp):.7g} (rel {dm:.3e}, limit "
        f"{TOL_GRAD_MASS:g})")
    check(dm <= TOL_GRAD_MASS,
          f"Kerr integrator mass gradient outside {TOL_GRAD_MASS:g}")

    # the fan's rays one by one: rk4_fwd, then rk4_ckpt
    what = f"Kerr integrator {n}"
    s0 = initial_state(env, x0, d0)
    with torch.no_grad():
        sk = cuda_kernel.integrate_cuda(env, s0, cfg)
        sp = cuda_kernel.integrate_plain(env, s0, cfg)
    e, aligned, dlam = compare_flagship(env, cfg, s0, sk, sp, what)
    r = readings["rk4_fwd_kerr"]
    r.update(max_abs_err=max(r.get("max_abs_err", 0.0), e),
             rays_aligned=r.get("rays_aligned", 0) + aligned,
             dlam_near_b_c=dlam)
    e, bitwise = ckpt_against_fwd([(what, env, cfg, s0)], "phase 18")
    r = readings["rk4_ckpt_kerr"]
    r.update(max_abs_err=max(r.get("max_abs_err", 0.0), e),
             equals_rk4_fwd=r.get("equals_rk4_fwd", True) and bitwise)

    # rk4_bwd's per-ray cotangents, away from b_c, for weighted final
    # positions and directions (phase 6's loss)
    near = near_b_c(env, s0)
    rng = np.random.default_rng(6)
    wx, wd = (torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                              device=dev) for _ in range(2))

    def smooth(s):
        ok = (s.status != states.CAPTURED) & (s.status != states.ERROR)
        f = wx * s.x + wd * final_direction(env, s)
        return torch.where(ok[..., None], f, 0.0).sum()

    out_k, rk = kerr_grads(env, s0, cfg, smooth, True)
    out_p, rp = kerr_grads(env, s0, cfg, smooth, False)
    kink = near_kink(env, cfg, s0) & ~near
    away = ~near & ((out_k.lam - out_p.lam).abs() <= TOL_X)
    keep = away & ~kink
    errs = [rel_err(a[keep], b[keep]) for a, b in zip(rk[:3], rp[:3])]
    log(f"# grad [{what} rays away from b_c and the schedule's kinks, "
        f"smooth loss] n={int(keep.sum())}: per-ray cotangents x "
        f"{errs[0]:.3e} p {errs[1]:.3e} E {errs[2]:.3e} (max |d| / max "
        f"|plain|, limit {TOL_GRAD:g}); with the {int(kink.sum())} rays by a"
        f" kink: x {rel_err(rk[0][away], rp[0][away]):.3e}; near b_c "
        f"({int(near.sum())} rays): x {rel_err(rk[0][near], rp[0][near]):.3e}"
        f"; mass {float(rk[3]):.7g} vs {float(rp[3]):.7g}, spin "
        f"{float(rk[4]):.7g} vs {float(rp[4]):.7g} (readings)")
    check(max(errs) <= TOL_GRAD,
          f"{what}: per-ray cotangents away from b_c outside {TOL_GRAD:g}")
    r = readings["rk4_bwd_kerr"]
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), *errs, dm)
    rk4_order_check(f"phase 18 [{what}]", env, cfg, s0, wx, readings)

    # times: bench.py's row, and each kernel on the fan's rays against its
    # plain version
    scal = cuda_kernel._scalars(env, cfg, dev)
    seg = cuda_kernel.segment(cfg.n_steps)
    args = (scal, s0.x, s0.p, s0.E, s0.lam, s0.status)
    fwd = no_grad(lambda: cuda_kernel.rk4_fwd(*args, cfg.n_steps, 1.5,
                                              kerr=True))
    ckpt = no_grad(lambda: cuda_kernel.rk4_ckpt(*args, cfg.n_steps, seg,
                                                1.5, kerr=True))
    ck = ckpt()[-1]
    g = torch.ones_like(s0.x)
    bwd = no_grad(lambda: cuda_kernel.rk4_bwd(scal, ck, s0.E, g, g,
                                              cfg.n_steps, seg, 1.5,
                                              kerr=True))

    def plain_forward():
        x = s0.x.detach().clone().requires_grad_(True)
        s = dataclasses.replace(s0, x=x)
        return cuda_kernel.integrate_plain(env, s, cfg).x.sum()

    ms = {"forward (kernel)": timed(lambda: forward("auto")),
          "forward+gradient (kernels)": timed(lambda: gradient("auto")),
          "forward (plain)": once_ms(lambda: forward("torch")),
          "forward+gradient (plain)": once_ms(lambda: gradient("torch")),
          "rk4_fwd_kerr call": timed(fwd),
          "rk4_ckpt_kerr call": timed(ckpt),
          "rk4_bwd_kerr call": timed(bwd),
          "plain integrator, forward": once_ms(no_grad(
              lambda: cuda_kernel.integrate_plain(env, s0, cfg))),
          "plain checkpointed loop, forward": once_ms(plain_forward),
          "plain checkpointed loop, backward": backward_ms(plain_forward)}
    for k, v in ms.items():
        log(f"# phase 18: Kerr integrator {k} {n} rays: median "
            f"{v:.3f} ms, {n / (v * 1e-3):.4e} rays/s [{name_limit}]")
    dev_ms = {"rk4_fwd_kerr": device_ms(fwd), "rk4_ckpt_kerr": device_ms(ckpt),
              "rk4_bwd_kerr": device_ms(bwd)}
    log("# phase 18: device time (CUDA events, median of 10): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in dev_ms.items())
        + f" [{name_limit}]")
    for name, plain in (("rk4_fwd_kerr", "plain integrator, forward"),
                        ("rk4_ckpt_kerr", "plain checkpointed loop, forward"),
                        ("rk4_bwd_kerr",
                         "plain checkpointed loop, backward")):
        readings[name].update(ms=ms[f"{name} call"], device_ms=dev_ms[name],
                              plain_ms=ms[plain])
    readings["kerr_integrator"] = {k: ms[k] for k in list(ms)[:4]}


# =============================================================================
# Adaptive Dormand-Prince: dopri_fwd (K4), dopri_ckpt (K5), dopri_bwd (K6).
# =============================================================================
def adaptive_cfg(n_steps=2000, max_step=8.0, backend="auto"):
    """bench.py's bench_adaptive configuration (:528-531): Dormand-Prince,
    rtol 1e-5, atol 1e-8, first step 0.05, at most n_steps trips."""
    return P.IntegratorConfig(n_steps=n_steps, dt=0.05, method="dopri",
                              rtol=1e-5, atol=1e-8, max_step=max_step,
                              backend=backend)


def angle(env, a, b):
    """Per ray, the angle between the final directions of the states a and
    b, as 2 asin(|a - b| / 2) in float64."""
    chord = (final_direction(env, a) - final_direction(env, b)).norm(dim=-1)
    return 2.0 * torch.asin((0.5 * chord.double()).clamp(max=1.0))


def masked_max(t, m) -> float:
    return float(t[m].max()) if bool(m.any()) else 0.0


def compare_adaptive(env, s0, a, b, what, max_step):
    """Kernel state ``a`` against the plain trip loop's ``b`` from ``s0``
    (see DOPRI_AGREE): the reference's invariants on every ray (sky
    directions away from b_c), and, away from b_c, the rays that took the
    same trips (lam within TOL_X) to TOL_DIR on the sky, and event points
    within DOPRI_EVENT_X.  Returns (error, rays away from b_c that took
    other trips)."""
    same = (a.status == b.status) & (a.hit_obj == b.hit_obj)
    agree = float(same.float().mean())
    dlam = (a.lam - b.lam).abs()
    ang = angle(env, a, b)
    sky = (b.status == states.ESCAPED) | (b.status == states.BUDGET)
    ev = (b.status == states.DISK) | (b.status == states.OBJECT)
    near = near_b_c(env, s0)
    away = same & ~near
    trips = away & (dlam <= TOL_X)
    n_apart = int((away & ~trips).sum())
    share = n_apart / max(int(away.sum()), 1)
    dl = masked_max(dlam, same)
    ang_sky = masked_max(ang, away & sky)
    ang_near = masked_max(ang, same & near & sky)
    ang_t = masked_max(ang, trips & sky)
    dx_ev = masked_max((a.x - b.x).abs().amax(-1), same & ~near & ev)
    hist = torch.bincount(b.status.reshape(-1).long(), minlength=8).tolist()
    log(f"# dopri [{what}] n={same.numel()} statuses and hit ids equal on "
        f"{agree:.6f}; max|dlam| {dl:.3e} (limit {max_step:g}); sky "
        f"directions {ang_sky:.3e} rad away from b_c, {ang_near:.3e} near "
        f"it; {n_apart} rays away from b_c ({share:.4f}) took other trips; "
        f"the others: sky {ang_t:.3e} rad; event points {dx_ev:.3e}; "
        f"CAPTURED {hist[1]} ESCAPED {hist[2]} BUDGET {hist[3]} DISK "
        f"{hist[4]} OBJECT {hist[5]}")
    if not (agree >= DOPRI_AGREE and dl <= max_step + 1e-3
            and ang_sky < DOPRI_ANGLE and ang_t <= TOL_DIR
            and dx_ev <= DOPRI_EVENT_X and share <= DOPRI_APART):
        raise AssertionError(
            f"{what}: outside the Dormand-Prince invariants (statuses "
            f"{DOPRI_AGREE}, lam {max_step:g}, sky {DOPRI_ANGLE:g} rad, "
            f"event points {DOPRI_EVENT_X:g}; same trips {TOL_DIR:g} rad; "
            f"other trips {DOPRI_APART})")
    return max(ang_t, dx_ev), n_apart


def dopri_batches(dev):
    """(label, environment, initial state) of the Dormand-Prince fans: the
    65,536-ray camera fan around a Schwarzschild hole and around a = 0.45
    (the band around the critical impact parameter left out), and the
    events fan over the disk and the moons of bench.py's events scene
    around each."""
    env, kenv = fan_env(dev), kerr_env(0.45, dev)
    out = [(f"fan {FAN}", env, initial_state(env, *camera_fan(FAN, dev))),
           (f"Kerr a=0.45 fan {FAN}", kenv,
            initial_state(kenv, *camera_fan(FAN, dev, kerr_gap(kenv))))]
    for tag, e in (("", env), ("Kerr a=0.45 ", kenv)):
        ee = with_events(e)
        out.append((f"{tag}events fan {FAN}", ee,
                    initial_state(ee, *events_fan(FAN, dev))))
    return out


def dopri_name(kind, env):
    return cuda_kernel.variant(f"dopri_{kind}", env.spin is not None,
                               env.disk is not None or env.spheres is not None)


def phase_dopri_fwd(dev, readings):
    """dopri_fwd against integrate_adaptive on the card (bench.py's
    adaptive configuration), and bench.py's dopri parity rows."""
    cfg = adaptive_cfg()
    for what, e, s0 in dopri_batches(dev):
        with torch.no_grad():
            sk = cuda_kernel.integrate_cuda(e, s0, cfg)
            sp, _ = cuda_kernel.integrate_adaptive(e, s0, cfg)
        got = phase(f"phase 20 ({what})", compare_adaptive, e, s0, sk, sp,
                    what, cfg.max_step)
        if got is not None:
            r = readings[dopri_name("fwd", e)]
            r.update(max_abs_err=max(r.get("max_abs_err", 0.0), got[0]),
                     other_trips=r.get("other_trips", 0) + got[1])
    # bench.py's run_dopri (:253-308): its 4,096-ray fan, 1000 trips,
    # max_step 4, with and without the disk and two spheres; statuses on
    # >= 99.8% and escaped directions within 2e-3 rad
    x0, d0 = camera_fan(4096, dev)
    for events in (False, True):
        e = fan_env(dev)
        if events:
            e = with_events(e, [[7.0, 0.0, 0.0], [-5.0, -5.0, 1.0]],
                            [1.0, 0.8])
        cfg = adaptive_cfg(1000, 4.0)
        s0 = initial_state(e, x0, d0)
        with torch.no_grad():
            sk = cuda_kernel.integrate_cuda(e, s0, cfg)
            sp, _ = cuda_kernel.integrate_adaptive(e, s0, cfg)
        agree = sk.status == sp.status
        esc = agree & (sp.status == states.ESCAPED)
        derr = masked_max(angle(e, sk, sp), esc)
        frac = float(agree.float().mean())
        row = "dopri-events" if events else "dopri"
        log(f"# phase 20: bench.py dopri parity [{row}] statuses={frac:.4f} "
            f"escape_dir_err={derr:.3e}")
        check(frac >= DOPRI_AGREE and derr < DOPRI_ANGLE,
              f"bench.py dopri parity row (events={events}) failed")
    log("# phase 20: dopri_fwd agrees with the plain trip loop on the card")


def dopri_args(env, cfg, s0):
    """(scal, x, p, E, h, lam, status, n_steps, controller) and the event
    keywords of the dopri wrappers for the flat state ``s0``."""
    h = torch.full_like(s0.E, dopri_h0(cfg))
    return ((cuda_kernel._scalars(env, cfg, s0.x.device), s0.x, s0.p, s0.E,
             h, s0.lam, s0.status, cfg.n_steps), cuda_kernel.controller(cfg),
            event_kw(env, s0))


def phase_dopri_ckpt(dev, readings):
    """dopri_ckpt's final state against dopri_fwd's, bit for bit, and its
    checkpoint rows against the plain trip loop's states and h at the same
    trips: the Dormand-Prince fans at bench.py's gradient row's 600 trips;
    and bit for bit alone on the rays of the two Einstein rings.  On every
    case both kernels' outputs, checkpoints and live counts equal the
    NO_GUARD build's bit for bit."""
    cfg = adaptive_cfg(600)
    cases = [(what, e, cfg, flat_state(s0), True)
             for what, e, s0 in dopri_batches(dev)]
    for spin in (None, 0.45):
        scene, cam, rcfg = ring_scene(dev, spin)
        fenv, s0 = flagship_rays(scene, cam, rcfg, dev, RING)
        cases.append((f"{RING}x{RING} " + ("" if spin is None else "Kerr ")
                      + "Einstein ring", fenv, rcfg.integrator,
                      flat_state(s0), False))
    bitwise, errs = {}, {}
    for what, e, c, s0, with_rows in cases:
        args, ctl, kw = dopri_args(e, c, s0)
        seg = cuda_kernel.segment(c.n_steps)

        def run():
            with torch.no_grad():
                fwd = cuda_kernel.dopri_fwd(*args, ctl, **kw)
                *fin, ck = cuda_kernel.dopri_ckpt(*args, seg, ctl, **kw)
            return fwd, fin, ck

        fwd, fin, ck = run()
        same = all(torch.equal(a, b) for a, b in zip(fwd, fin))
        name = dopri_name("ckpt", e)
        bitwise[name] = bitwise.get(name, True) and same
        check(same, f"{what}: dopri_ckpt's final state differs from "
              "dopri_fwd's")
        # the sphere guard (both kernels take it) changes no bit
        with _build.built_with(*NO_GUARD):
            witness = run()
        unguarded = all(torch.equal(a, b) for a, b in zip(
            (*fwd, *fin, *ck), (*witness[0], *witness[1], *witness[2])))
        del witness
        check(unguarded, f"{what}: dopri_fwd or dopri_ckpt differs from its "
              "build without the sphere guard")
        msg = ""
        if with_rows:
            with torch.no_grad():
                _, rows, hs = cuda_kernel.integrate_adaptive_ckpt_plain(
                    e, s0, c, seg)
            near = near_b_c(e, s0)
            worst_st, worst_dx, worst_dh, fewest = 1.0, 0.0, 0.0, 1.0
            for k, (row, h) in enumerate(zip(rows, hs)):
                cx, cp, ch, clam, cst = (t[k] for t in ck[:5])
                worst_st = min(worst_st,
                               float((cst == row.status).float().mean()))
                keep = ((clam - row.lam).abs() <= TOL_X) & ~near
                fewest = min(fewest, float(keep.float().mean()))
                worst_dx = max(worst_dx, masked_max(
                    (cx - row.x).abs().amax(-1), keep))
                worst_dh = max(worst_dh, masked_max((ch - h).abs() / h, keep))
            msg = (f"; {len(rows)} checkpoint rows of seg {seg}: statuses "
                   f"equal on >= {worst_st:.6f}; away from b_c >= "
                   f"{fewest:.4f} of the rays on the same trips (lam), their "
                   f"max|dx| {worst_dx:.3e}, h relative {worst_dh:.3e}")
            check(worst_st >= DOPRI_AGREE and worst_dx <= DOPRI_EVENT_X
                  and fewest >= 1.0 - DOPRI_APART,
                  f"{what}: dopri_ckpt's checkpoint rows outside "
                  f"({DOPRI_AGREE}, {DOPRI_EVENT_X:g}, {DOPRI_APART})")
            errs[name] = max(errs.get(name, 0.0), worst_dx)
        log(f"# phase 21: [{what}] dopri_ckpt "
            + ("equals dopri_fwd bit for bit" if same else "DIFFERS") + msg
            + "; " + live_equal(ck, what) + "; both "
            + ("equal" if unguarded else "DIFFER from")
            + " the build without the sphere guard")
    for name, same in bitwise.items():
        readings[name].update(equals_dopri_fwd=same,
                              max_abs_err=errs.get(name, 0.0))


def weak_env(dev, spin=None, events=False):
    """The environments of tests/test_pallas.py's dopri gradient tests
    (:241-287, :324-353): r_escape 60, lam_max 70, capture at r = 1 (Kerr:
    at r_+), with the disk r_in 5, r_out 9 and a sphere of radius 1.5 at
    (6.5, 0, 10)."""
    f = lambda v: torch.tensor(v, device=dev)  # noqa: E731
    e = GeodesicEnv(mass=f(0.5), r_capture=f(1.0), r_escape=f(60.0),
                    lam_max=f(70.0))
    if spin is not None:
        e.spin = f(spin)
        e.r_capture = horizon_radius(e.mass, e.spin)
    if events:
        e.disk = DiskGeom(r_in=f(5.0), r_out=f(9.0))
        e.spheres = SphereGeom(center=f([[6.5, 0.0, 10.0]]), radius=f([1.5]))
    return e


def weak_fan(n, dev, seed=3):
    """The weak-field fan of those tests: b in [6.5, 12] at z = 25,
    direction -z, and weights for the loss."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(6.5, 12.0, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return f(x0), f(d0), f(rng.normal(size=(n, 3)))


def observable_loss(env, s, w):
    """The reference's loss (tests/test_pallas.py:262-275): weighted event
    points, and weighted final directions of the rays that end on the sky
    or are still ACTIVE."""
    ev = ((s.status == states.DISK) | (s.status == states.OBJECT))[..., None]
    sky = ((s.status != states.CAPTURED) & (s.status != states.ERROR)
           )[..., None] & ~ev
    return (torch.where(sky, w * final_direction(env, s), 0.0)
            + torch.where(ev, w * s.x, 0.0)).sum()


def dopri_order_check(tag, env, cfg, s0, w, readings):
    """order_check of dopri_bwd on dopri_ckpt's checkpoints of the flat
    state ``s0``, with the cotangent ``w`` for the final x and p; held to
    TOL_DOPRI_GRAD_SCALAR."""
    args, ctl, kw = dopri_args(env, cfg, s0)
    seg = cuda_kernel.segment(cfg.n_steps)
    with torch.no_grad():
        ck = cuda_kernel.dopri_ckpt(*args, seg, ctl, **kw)[-1]
    del kw["obj"]
    order_check(tag, dopri_name("bwd", env), lambda o: cuda_kernel.dopri_bwd(
        args[0], ck, s0.E, w, w, cfg.n_steps, seg, ctl, tile_order=o, **kw),
        TOL_DOPRI_GRAD_SCALAR, readings)


def phase_dopri_bwd(dev, readings):
    """dopri_bwd against autograd of integrate_adaptive_scan on the card:
    the weak-field fans of the reference, Schwarzschild and Kerr, with and
    without the disk and the sphere, at 96 or 80 trips (every ray ends) and
    at 20 (every ray still ACTIVE); per-ray cotangents of the rays that
    took the same trips, the mass, spin and sphere cotangents; two runs
    give the same bits."""
    x0, d0, w = weak_fan(FAN, dev)
    cases = [(None, False, 96), (None, True, 96), (None, True, 20),
             (0.45, False, 80), (0.45, True, 80), (0.45, False, 20)]
    err = {}
    for spin, events, n in cases:
        e = weak_env(dev, spin, events)
        what = (f"weak fan {FAN}" + (f", Kerr a={spin:g}" if spin else "")
                + (", disk and sphere" if events else "") + f", {n} trips")
        cfg = adaptive_cfg(n, 4.0)
        s0 = initial_state(e, x0, d0)
        loss = lambda s, e=e: observable_loss(e, s, w)  # noqa: E731
        out_k, gk = kerr_grads(e, s0, cfg, loss, True) if spin else \
            event_or_plain_grads(e, s0, cfg, loss, True)
        out_p, gp = kerr_grads(e, s0, cfg, loss, False) if spin else \
            event_or_plain_grads(e, s0, cfg, loss, False)
        same = ((out_k.status == out_p.status)
                & ((out_k.lam - out_p.lam).abs() <= TOL_X))
        ev = (out_p.status == states.DISK) | (out_p.status == states.OBJECT)
        sky = same & ~ev
        rr = [ray_rel(a, b) for a, b in zip(gk[:3], gp[:3])]
        med = [float(r[sky].median()) for r in rr]
        q90 = [float(r[sky].quantile(0.9)) for r in rr]
        errs = [rel_err(a[sky], b[sky]) for a, b in zip(gk[:3], gp[:3])]
        ev_errs = [rel_err(a[same & ev], b[same & ev]) if bool(ev.any())
                   else 0.0 for a, b in zip(gk[:3], gp[:3])]
        scalars = [rel_err(a, b) for a, b in zip(gk[3:], gp[3:])
                   if a is not None]
        active = int((out_p.status == states.ACTIVE).sum())
        log(f"# grad [{what}: {int(sky.sum())} sky or ACTIVE rays and "
            f"{int((same & ev).sum())} event rays on the same trips, "
            f"{active} ACTIVE at the end] per ray |d| / |plain|, median "
            f"(90th percentile): x {med[0]:.3e} ({q90[0]:.3e}) p "
            f"{med[1]:.3e} ({q90[1]:.3e}) E {med[2]:.3e} ({q90[2]:.3e}); "
            f"max |d| / max |plain| x {errs[0]:.3e} p {errs[1]:.3e} E "
            f"{errs[2]:.3e}, event rays x {ev_errs[0]:.3e} p "
            f"{ev_errs[1]:.3e} E {ev_errs[2]:.3e} (readings); mass"
            + (", spin" if spin else "") + (", spheres" if events else "")
            + " " + " ".join(f"{v:.3e}" for v in scalars)
            + f" (mass {float(gk[3]):.7g} vs {float(gp[3]):.7g})")
        check(max(med[:2]) <= TOL_DOPRI_GRAD
              and max(scalars) <= TOL_DOPRI_GRAD_SCALAR,
              f"{what}: cotangents outside {TOL_DOPRI_GRAD:g} (median; "
              f"scalars {TOL_DOPRI_GRAD_SCALAR:g})")
        name = dopri_name("bwd", e)
        err[name] = max(err.get(name, 0.0), *med[:2], *scalars)
        dopri_order_check(f"phase 22 [{what}]", e, cfg, flat_state(s0), w,
                          readings)
    for name, v in err.items():
        readings[name]["max_abs_err"] = v
    # two runs of dopri_bwd give the same bits
    e = weak_env(dev, 0.45, True)
    s0 = flat_state(initial_state(e, x0, d0))
    cfg = adaptive_cfg(96, 4.0)
    args, ctl, kw = dopri_args(e, cfg, s0)
    del kw["obj"]
    seg = cuda_kernel.segment(cfg.n_steps)
    with torch.no_grad():
        ck = cuda_kernel.dopri_ckpt(*args, seg, ctl, **kw)[-1]
        runs = [cuda_kernel.dopri_bwd(args[0], ck, s0.E, w, w, cfg.n_steps,
                                      seg, ctl, **kw) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log("# determinism: two runs of dopri_bwd's Kerr event variant give "
        + ("bitwise-equal" if same else "DIFFERENT") + " outputs")
    check(same, "dopri_bwd is not deterministic")
    log("# phase 22: dopri_bwd agrees with autograd of the plain trip loop")


def ray_rel(a, b):
    """Per ray, |a - b| / |b| over the last axis, |b| floored at 1e-3 of
    the largest (rays whose cotangent is nearly 0 do not divide by it)."""
    nb = b.norm(dim=-1) if b.dim() > 1 else b.abs()
    d = (a - b).norm(dim=-1) if b.dim() > 1 else (a - b).abs()
    return d / (nb + 1e-3 * nb.max())


def event_or_plain_grads(env, s0, cfg, loss_fn, kernel):
    """integrator_grads, with the (K, 4) sphere cotangent when ``env`` has
    spheres (event_grads); the mass's as entry 3 either way."""
    if env.spheres is not None:
        return event_grads(env, s0, cfg, loss_fn, kernel)
    return integrator_grads(env, s0, cfg, loss_fn, kernel)


def ring_scene(dev, spin=None):
    """BASELINE config 2 (tests/test_golden_baseline.py:65-91) at RING^2:
    the 64x128 sky, a pure-green moon of radius 1 at (0, 0, -12) behind a
    hole of mass 0.5 (and spin ``spin``), camera (0, 0, 20), fov 0.9,
    Dormand-Prince n_steps 2000, dt 0.5, rtol 1e-5, atol 1e-8, max_step 2,
    lam_max 120."""
    moon = np.zeros((1, 8, 16, 3), np.float32)
    moon[..., 1] = 1.0
    scene = P.Scene(
        bh=P.BlackHole.make(mass=0.5, spin=spin, device=dev),
        background=torch.as_tensor(make_sky(64, 128, check=8),
                                   dtype=torch.float32, device=dev),
        spheres=P.Spheres.make(center=[[0.0, 0.0, -12.0]], radius=[1.0],
                               texture=moon, device=dev))
    cam = P.Camera.make(position=(0.0, 0.0, 20.0), fov=(0.9, 0.9),
                        device=dev)
    cfg = P.RenderConfig(width=RING, height=RING, samples=1, lam_max=120.0,
                         integrator=P.IntegratorConfig(
                             n_steps=2000, dt=0.5, method="dopri", rtol=1e-5,
                             atol=1e-8, max_step=2.0))
    return scene, cam, cfg


def plain(cfg):
    """``cfg`` on the plain PyTorch path."""
    return dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, backend="torch"))


def ring_grads(scene0, cam0, cfg, mask=None, timing=None):
    """d mean(img[..., :3]^2) / d (mass, camera position, sky, the moon's
    centre and radius (4,), and the spin for a Kerr hole); ``mask`` (H, W)
    weights the pixels; ``timing`` (a dict) gets the ms of the forward and
    of the backward."""
    leaf = lambda t: t.detach().clone().requires_grad_(True)  # noqa: E731
    bh, sph = scene0.bh, scene0.spheres
    scene = dataclasses.replace(
        scene0, background=leaf(scene0.background),
        bh=dataclasses.replace(bh, mass=leaf(bh.mass),
                               spin=None if bh.spin is None
                               else leaf(bh.spin)),
        spheres=dataclasses.replace(sph, center=leaf(sph.center),
                                    radius=leaf(sph.radius)))
    cam = dataclasses.replace(cam0, position=leaf(cam0.position))
    with shade_as(cfg):
        img, t_fwd = once(lambda: P.render_image(scene, cam, cfg))
        sq = img[..., :3].pow(2)
        if mask is not None:
            sq = sq * mask[..., None]
        _, t_bwd = once(sq.mean().backward)
    if timing is not None:
        timing.update(fwd=t_fwd, bwd=t_bwd)
    out = (scene.bh.mass.grad, cam.position.grad, scene.background.grad,
           torch.cat([scene.spheres.center.grad[0],
                      scene.spheres.radius.grad[:1]]))
    return out if bh.spin is None else out + (scene.bh.spin.grad,)


RING_PARTS = ("mass", "camera", "sky", "moon", "spin")


def compare_ring_grads(gk, gp, what, tol, held=RING_PARTS):
    """The ring's gradients, kernel path against plain path: each part's
    max |d| / max |plain|; those in ``held`` within ``tol``."""
    errs = dict(zip(RING_PARTS, (rel_err(a, b) for a, b in zip(gk, gp))))
    log(f"# grad [{what}] " + "; ".join(
        f"{k} {errs[k]:.3e}" for k in errs)
        + f" (mass {float(gk[0]):.7g} vs {float(gp[0]):.7g}; moon "
        f"{gk[3].tolist()} vs {gp[3].tolist()})")
    bad = [k for k in errs if k in held and errs[k] > tol]
    check(not bad, f"{what}: {bad} outside {tol:g}")
    return errs


def pool4(img):
    h, w, c = img.shape
    return img.reshape(h // 4, 4, w // 4, 4, c).mean((1, 3))


def phase_dopri_ring(dev, name_limit, readings, spin=None):
    """BASELINE config 2, the RING^2 Einstein ring (with ``spin``, around a
    Kerr hole of a = spin): the forward render through dopri_fwd's event
    variant alone, held to the golden einstein_ring_512 and its physics
    oracles (Schwarzschild) and to the plain render, its final states to
    the plain trip loop's; the gradient of mean(img^2) to the mass, the
    camera, the sky and the moon's centre and radius (and the spin)
    through dopri_ckpt and dopri_bwd alone, held to the plain path: the
    sky whole, and (Schwarzschild) the mass, camera and moon on the calm
    pixels; times."""
    tag = "Einstein ring" if spin is None else f"Kerr a={spin:g} Einstein ring"
    tag = f"{RING}x{RING} {tag}"
    suffix = "_events" if spin is None else "_kerr_events"
    fwd_k, ckpt_k, bwd_k = (f"dopri_{k}{suffix}" for k in ("fwd", "ckpt",
                                                            "bwd"))
    scene, cam, cfg = ring_scene(dev, spin)
    reset_counts()
    with torch.no_grad():
        img, t_fwd = once(lambda: P.render_image(scene, cam, cfg))
    launches = read_counts()
    readings[fwd_k]["launches"] = launches.get(fwd_k, 0)
    check(launches == only(**{fwd_k: 1}),
          f"{tag} render launched {launches}, expected {fwd_k} once")
    if img.shape != (RING, RING, 4) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{tag} image is not a finite {RING}^2 x 4")
    with torch.no_grad():
        img_plain, t_fwd_plain = once(
            lambda: P.render_image(scene, cam, plain(cfg)))
    image_rule(img, img_plain, f"{tag}, kernel vs plain", GOLDEN_MEAN,
               GOLDEN_FRAC)
    if spin is None:
        # tests/test_golden_baseline.py:78-91: the golden (4x mean-pooled,
        # float16) and the physics oracles
        ref = np.load(ROOT / "tests" / "golden" / "einstein_ring_512.npz")[
            "img"].astype(np.float32)
        small = pool4(img.cpu().numpy()).astype(np.float16).astype(np.float32)
        diff = np.abs(small - ref)
        c, q = RING // 2, RING / 512   # the oracles' pixels at 512^2
        oracles = (bool((img[c, c, :3] < 0.02).all()),
                   float(img[c, c + int(100 * q):c + int(180 * q), 1].max())
                   > 0.5, float(img[c, c + int(30 * q), 1]) < 0.3)
        log(f"# golden [einstein_ring_512, kernel] mean drift "
            f"{diff.mean():.3e} (limit 1e-3), {(diff > 0.05).mean():.3e} of "
            f"cells moved > 0.05 (limit 0.005); shadow black, ring green, "
            f"interior dark: {oracles}")
        check(diff.mean() < 1e-3 and (diff > 0.05).mean() < 0.005
              and all(oracles), f"{tag}: golden or oracles failed")
    fenv, s0 = flagship_rays(scene, cam, cfg, dev, RING)
    icfg = cfg.integrator
    with torch.no_grad():
        sk = cuda_kernel.integrate_cuda(fenv, s0, icfg)
        sp, _ = cuda_kernel.integrate_adaptive(fenv, s0, icfg)
    got = phase(f"{tag} final states", compare_adaptive, fenv, s0, sk, sp,
                tag, icfg.max_step)
    if got is not None:
        r = readings[fwd_k]
        r.update(max_abs_err=max(r.get("max_abs_err", 0.0), got[0]),
                 other_trips=r.get("other_trips", 0) + got[1])

    # forward+backward through dopri_ckpt and dopri_bwd
    reset_counts()
    gk, t_step = once(lambda: ring_grads(scene, cam, cfg))
    launches, shaded = read_counts(), read_shading()
    for name in (ckpt_k, bwd_k):
        readings[name]["launches"] = launches.get(name, 0)
    check(launches == only(**{ckpt_k: 1, bwd_k: 1})
          and shaded == shading(spin is not None, fwd=1, bwd=1, tex=1),
          f"{tag} forward+backward launched {launches}, {shaded}, expected "
          f"{ckpt_k} and {bwd_k} once each, the shading's forward and "
          "backward once each and its texture scatter once (the sky)")
    for g in gk:
        check(bool(torch.isfinite(g).all()), f"{tag} gradient not finite")
    timing = {}
    gp, t_step_plain = once(lambda: ring_grads(scene, cam, plain(cfg),
                                               timing=timing))
    errs = compare_ring_grads(gk, gp, f"{tag}, kernel vs plain (the sky "
                              "held, the rest a reading)", TOL_EVENTS_GRAD,
                              held=("sky",))
    held = [errs["sky"]]
    if spin is None:
        # the calm pixels: away from b_c, the sky's pole, the silhouettes
        # of the shadow and the moon, texel flips and rays whose trips
        # differ between the two paths
        end = final_direction(fenv, sp)
        rho = end[..., :2].norm(dim=-1)
        flips = texel_flips(scene, sk, final_direction(fenv, sk), sp, end)
        parts = {"near b_c": near_b_c(fenv, s0), "near the pole":
                 rho < POLE_RHO,
                 "silhouettes": silhouettes(sp.status, sp.hit_obj),
                 "other trips": (sk.lam - sp.lam).abs() > TOL_X,
                 "texel flips": flips}
        calm = torch.ones_like(rho, dtype=torch.bool)
        for name, m in parts.items():
            calm &= ~m
            log(f"# grad [{tag}] {int(m.sum())} pixels {name}")
        mk = calm.float()
        calm_errs = compare_ring_grads(
            ring_grads(scene, cam, cfg, mk), ring_grads(scene, cam,
                                                        plain(cfg), mk),
            f"{tag}, {int(calm.sum())} calm pixels, kernel vs plain",
            TOL_CALM_GRAD)
        held += list(calm_errs.values())
    readings[bwd_k]["render_grad_err"] = max(held)

    # times: the kernels on the frame's rays, against their plain versions
    flat = flat_state(s0)
    args, ctl, kw = dopri_args(fenv, icfg, flat)
    seg = cuda_kernel.segment(icfg.n_steps)
    fwd = no_grad(lambda: cuda_kernel.dopri_fwd(*args, ctl, **kw))
    ckpt = no_grad(lambda: cuda_kernel.dopri_ckpt(*args, seg, ctl, **kw))
    ck = ckpt()[-1]
    bkw = dict(kw)
    del bkw["obj"]
    g = torch.ones_like(flat.x)
    bwd = no_grad(lambda: cuda_kernel.dopri_bwd(args[0], ck, flat.E, g, g,
                                                icfg.n_steps, seg, ctl,
                                                **bkw))
    if spin is not None:
        runs = [bwd() for _ in range(2)]
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        log(f"# determinism: two runs of {bwd_k} on the {tag} rays give "
            + ("bitwise-equal" if same else "DIFFERENT") + " outputs")
        check(same, f"{bwd_k} is not deterministic")
    dopri_order_check(tag, fenv, icfg, flat, g, readings)
    _, t_plain_int = once(no_grad(
        lambda: cuda_kernel.integrate_adaptive(fenv, s0, icfg)))
    ms = {"forward render (kernel)": t_fwd,
          "forward render (plain)": t_fwd_plain,
          "forward+backward step (kernels)": timed(
              lambda: ring_grads(scene, cam, cfg), runs=3),
          "forward+backward step (plain)": t_step_plain,
          f"{fwd_k} call": timed(fwd, runs=5),
          f"{ckpt_k} call": timed(ckpt, runs=5),
          f"{bwd_k} call": timed(bwd, runs=5),
          "plain trip loop, forward": t_plain_int,
          # the plain step's forward and backward: the checkpointed trip
          # loop, with the camera and the shading (a few ms of seconds)
          "plain checkpointed trip loop, forward": timing["fwd"],
          "plain checkpointed trip loop, backward": timing["bwd"]}
    dev_ms = {k: device_ms(f, runs=5) for k, f in ((fwd_k, fwd),
                                                    (ckpt_k, ckpt),
                                                    (bwd_k, bwd))}
    for what, v in ms.items():
        log(f"# {tag}: {what}: {v:.3f} ms, "
            f"{RING * RING / (v * 1e-3):.4e} rays/s [{name_limit}]")
    log(f"# {tag}: device time (CUDA events, median of 5): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in dev_ms.items())
        + f" [{name_limit}]")
    for name, p in ((fwd_k, "plain trip loop, forward"),
                    (ckpt_k, "plain checkpointed trip loop, forward"),
                    (bwd_k, "plain checkpointed trip loop, backward")):
        readings[name].update(ms=ms[f"{name} call"], device_ms=dev_ms[name],
                              plain_ms=ms[p])
    readings[f"ring{suffix}"] = {
        "fwd_ms": t_fwd, "fwd_bwd_ms": ms["forward+backward step (kernels)"],
        "fwd_bwd_plain_ms": t_step_plain}


def phase_dopri_adaptive(dev, name_limit, readings, spin=None):
    """bench.py's bench_adaptive rows (:511-608) at ADAPTIVE_RAYS rays of
    its camera fan (M = 0.5, r_capture 1, r_escape 70, lam_max 100, rtol
    1e-5, atol 1e-8, max_step 8), around a Schwarzschild hole or (``spin``)
    a Kerr hole: the forward (2000 trips) through dopri_fwd alone, held to
    the plain trip loop; the gradient of sum(x^2) 1e-6 to the mass (and the
    spin) at 600 trips through dopri_ckpt and dopri_bwd alone, held to the
    plain path within bench.py's 1e-2; dopri_ckpt = dopri_fwd bit for bit
    on these rays; times."""
    env = fan_env(dev)
    if spin is not None:
        env.spin = torch.tensor(spin, device=dev)
    tag = "adaptive row" + ("" if spin is None else f", Kerr a={spin:g}")
    tag = f"{tag} {ADAPTIVE_RAYS}"
    suffix = "" if spin is None else "_kerr"
    fwd_k, ckpt_k, bwd_k = (f"dopri_{k}{suffix}" for k in ("fwd", "ckpt",
                                                            "bwd"))
    x0, d0 = camera_fan(ADAPTIVE_RAYS, dev)
    cfg_f, cfg_g = adaptive_cfg(2000), adaptive_cfg(600)

    def forward(backend):
        with torch.no_grad():
            return P.launch(env, x0, d0, dataclasses.replace(
                cfg_f, backend=backend))

    def gradient(backend, timing=None, order="cost"):
        leaf = lambda v: v.detach().clone().requires_grad_(True)  # noqa
        e = dataclasses.replace(env, mass=leaf(env.mass),
                                spin=None if spin is None else leaf(env.spin))
        s, t_f = once(lambda: P.launch(e, x0, d0, dataclasses.replace(
            cfg_g, backend=backend, tile_order=order)))
        _, t_b = once(((s.x ** 2).sum() * 1e-6).backward)
        if timing is not None:
            timing.update(fwd=t_f, bwd=t_b)
        return (e.mass.grad,) + (() if spin is None else (e.spin.grad,))

    reset_counts()
    sk, t_fwd = once(lambda: forward("auto"))
    launches = read_counts()
    readings[fwd_k]["launches"] = launches.get(fwd_k, 0)
    check(launches == only(**{fwd_k: 1}),
          f"{tag} forward launched {launches}, expected {fwd_k} once")
    reset_counts()
    gk, t_grad = once(lambda: gradient("auto"))
    launches = read_counts()
    for name in (ckpt_k, bwd_k):
        readings[name]["launches"] = launches.get(name, 0)
    check(launches == only(**{ckpt_k: 1, bwd_k: 1}),
          f"{tag} gradient launched {launches}, expected {ckpt_k} and "
          f"{bwd_k} once each")
    sp, t_fwd_plain = once(lambda: forward("torch"))
    timing = {}
    gp, t_grad_plain = once(lambda: gradient("torch", timing))
    s0 = initial_state(env, x0, d0)
    got = phase(f"{tag} final states", compare_adaptive, env, s0, sk, sp,
                tag, cfg_f.max_step)
    if got is not None:
        r = readings[fwd_k]
        r.update(max_abs_err=max(r.get("max_abs_err", 0.0), got[0]),
                 other_trips=r.get("other_trips", 0) + got[1])
    rels = [abs(float(a) / float(b) - 1.0) for a, b in zip(gk, gp)]
    log(f"# {tag}: d/dmass {float(gk[0]):.7g} vs plain {float(gp[0]):.7g} "
        f"(rel {rels[0]:.3e}, limit {TOL_ADAPTIVE_GRAD:g})"
        + ("" if spin is None else f"; d/dspin {float(gk[1]):.7g} vs "
           f"{float(gp[1]):.7g} (rel {rels[1]:.3e})"))
    check(rels[0] <= TOL_ADAPTIVE_GRAD
          and max(rels[1:], default=0.0) <= TOL_DOPRI_GRAD_SCALAR,
          f"{tag}: gradient outside {TOL_ADAPTIVE_GRAD:g} (spin "
          f"{TOL_DOPRI_GRAD_SCALAR:g})")
    r = readings[bwd_k]
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), *rels)

    # times: each kernel on the fan's rays against its plain version
    flat = flat_state(s0)
    args_f, ctl, kw = dopri_args(env, cfg_f, flat)
    args_g, _, _ = dopri_args(env, cfg_g, flat)
    seg = cuda_kernel.segment(cfg_g.n_steps)
    fwd = no_grad(lambda: cuda_kernel.dopri_fwd(*args_f, ctl, **kw))
    ckpt = no_grad(lambda: cuda_kernel.dopri_ckpt(*args_g, seg, ctl, **kw))
    with torch.no_grad():
        ck_out = ckpt()
        fin_f = cuda_kernel.dopri_fwd(*args_g, ctl, **kw)
    same = all(torch.equal(a, b) for a, b in zip(fin_f, ck_out[:5]))
    check(same, f"{tag}: dopri_ckpt's final state differs from dopri_fwd's")
    readings[ckpt_k]["equals_dopri_fwd"] = (
        readings[ckpt_k].get("equals_dopri_fwd", True) and same)
    g = torch.ones_like(flat.x)
    bwd = no_grad(lambda: cuda_kernel.dopri_bwd(
        args_g[0], ck_out[-1], flat.E, g, g, cfg_g.n_steps, seg, ctl,
        kerr=spin is not None))
    dopri_order_check(tag, env, cfg_g, flat, g, readings)
    _, t_plain_int = once(no_grad(
        lambda: cuda_kernel.integrate_adaptive(env, flat, cfg_f)))
    ms = {"forward (kernel)": t_fwd, "forward (plain)": t_fwd_plain,
          "forward+gradient (kernels)": timed(lambda: gradient("auto"),
                                              runs=3),
          "forward+gradient (kernels, input order)": timed(
              lambda: gradient("auto", order="none"), runs=3),
          "forward+gradient (plain)": t_grad_plain,
          f"{fwd_k} call": timed(fwd, runs=5),
          f"{ckpt_k} call": timed(ckpt, runs=5),
          f"{bwd_k} call": timed(bwd, runs=5),
          "plain trip loop, forward": t_plain_int,
          "plain checkpointed trip loop, forward": timing["fwd"],
          "plain checkpointed trip loop, backward": timing["bwd"]}
    dev_ms = {k: device_ms(f, runs=5) for k, f in ((fwd_k, fwd),
                                                    (ckpt_k, ckpt),
                                                    (bwd_k, bwd))}
    for what, v in ms.items():
        log(f"# {tag}: {what}: {v:.3f} ms, "
            f"{ADAPTIVE_RAYS / (v * 1e-3):.4e} rays/s [{name_limit}]")
    log(f"# {tag}: device time (CUDA events, median of 5): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in dev_ms.items())
        + f" [{name_limit}]")
    for name, p in ((fwd_k, "plain trip loop, forward"),
                    (ckpt_k, "plain checkpointed trip loop, forward"),
                    (bwd_k, "plain checkpointed trip loop, backward")):
        readings[name].update(ms=ms[f"{name} call"], device_ms=dev_ms[name],
                              plain_ms=ms[p])
    readings[f"adaptive{suffix}"] = {
        "fwd_ms": t_fwd, "fwd_grad_ms": ms["forward+gradient (kernels)"],
        "fwd_grad_plain_ms": t_grad_plain}


def trip_counts(env, cfg, s0, n_grad):
    """Per trip of the plain trip loop from ``s0`` (integrate_adaptive's),
    the ACTIVE rays and those whose sphere guard passes (the forward
    kernels' GUARD); and per kernel, "fwd" over all the trips and "ckpt"
    over the first ``n_grad``, each ray's trips and the trips rejected."""
    s, h = s0, torch.full_like(s0.E, dopri_h0(cfg))
    live, guard = [], []
    per_ray = {kind: torch.zeros_like(s0.E, dtype=torch.int32)
               for kind in ("fwd", "ckpt")}
    rejected = dict.fromkeys(per_ray, 0)
    with torch.no_grad():
        for trip in range(cfg.n_steps):
            act = s.active
            k = int(act.sum())
            if not k:
                break
            live.append(k)
            if env.spheres is not None:
                y, _, _, _ = dopri_step(env, s.x, s.p, s.E,
                                        torch.where(act, h, 0.0))
                guard.append(int((act & guard_pass(env, s.x, y)).sum()))
            s, h, accept = _dopri_trip(env, cfg, s, h)
            for kind in (("fwd", "ckpt") if trip < n_grad else ("fwd",)):
                per_ray[kind] += act.int()
                rejected[kind] += int((act & ~accept).sum())
    return live, guard, {kind: (per_ray[kind], rejected[kind])
                         for kind in per_ray}


def dopri_frames(dev):
    """The main path's frame of each Dormand-Prince variant, by name
    suffix: (environment, forward config, gradient config, flat initial
    state).  The ADAPTIVE_RAYS fans of bench.py's adaptive rows (2000
    trips forward, 600 for the gradient) for the event-free variants, the
    RING^2 Einstein rings for the event variants."""
    frames = {}
    for suffix, spin in (("", None), ("_kerr", 0.45)):
        env = fan_env(dev)
        if spin is not None:
            env.spin = torch.tensor(spin, device=dev)
        frames[suffix] = (env, adaptive_cfg(2000), adaptive_cfg(600),
                          flat_state(initial_state(
                              env, *camera_fan(ADAPTIVE_RAYS, dev))))
    for suffix, spin in (("_events", None), ("_kerr_events", 0.45)):
        scene, cam, cfg = ring_scene(dev, spin)
        fenv, s0 = flagship_rays(scene, cam, cfg, dev, RING)
        frames[suffix] = (fenv, cfg.integrator, cfg.integrator,
                          flat_state(s0))
    return frames


def dopri_launches(env, cfg_f, cfg_g, s0):
    """The launches of dopri_fwd and dopri_ckpt on the frame (``env``, the
    flat ``s0``) at their configs, by kind."""
    args, ctl, kw = dopri_args(env, cfg_f, s0)
    args_g, ctl_g, _ = dopri_args(env, cfg_g, s0)
    seg = cuda_kernel.segment(cfg_g.n_steps)
    return {"fwd": lambda: cuda_kernel.dopri_fwd(*args, ctl, **kw),
            "ckpt": lambda: cuda_kernel.dopri_ckpt(*args_g, seg, ctl_g, **kw)}


def dopri_ieee_deviation(tag, name, env, cfg, s0, launch, readings):
    """What the special-function unit's forms move in dopri_fwd's outputs
    (the trip's quot_ftz and step_u in dopri_trip.cuh, the Kerr right-hand
    side's rsqrt_ftz and rcp_ftz): ``launch()``'s (x, p, lam, status,
    hit_obj) against the same launch through the IEEE build, and each
    against the plain trip loop from the flat ``s0``, by compare_adaptive
    (statuses and hit ids that differ, rays away from b_c on other trips,
    sky directions held to phase 20's invariants, event points); and the
    rays that differ in some bit between the two builds."""
    with torch.no_grad():
        fast = launch()
        with _build.built_with(*IEEE):
            ieee = launch()
        plain, _ = cuda_kernel.integrate_adaptive(env, s0, cfg)

    def state(o):
        return dataclasses.replace(s0, x=o[0], p=o[1], lam=o[2],
                                   status=o[3], hit_obj=o[4])

    differ = int(((fast[0] != ieee[0]).any(-1) | (fast[1] != ieee[1]).any(-1)
                  | (fast[2] != ieee[2]) | (fast[3] != ieee[3])
                  | (fast[4] != ieee[4])).sum())
    log(f"# {tag}: {name} against its IEEE-reciprocal build: {differ} of "
        f"{fast[2].numel()} rays differ in some bit")
    dev = {"rays_differ": differ}
    for key, a, b in (("fast_vs_ieee", state(fast), state(ieee)),
                      ("fast_vs_plain", state(fast), plain),
                      ("ieee_vs_plain", state(ieee), plain)):
        got = phase(f"{tag} ({name} {key})", compare_adaptive, env, s0, a, b,
                    f"{name} {key}", cfg.max_step)
        if got is not None:
            dev[key] = {"error": got[0], "other_trips": got[1]}
    readings[name]["ieee_reciprocals"] = dev


def dopri_forward_rows(tag, suffix, env, cfg_f, cfg_g, s0, counts, readings,
                       name_limit):
    """The rows of the forward kernels' table for the variants dopri_fwd
    and dopri_ckpt + ``suffix`` on their main path's frame (``counts``:
    trip_counts' per kernel): ptxas's registers, stack and spills, the
    resident blocks per SM, the SASS size and census, the busy lanes and
    warps, the share of trips rejected, the device time in input order and
    its multiple of the bound; for a Kerr frame, dopri_fwd against its
    IEEE-reciprocal build (dopri_ieee_deviation)."""
    k = 0 if env.spheres is None else env.spheres.center.shape[0]
    kerr, disk = env.spin is not None, env.disk is not None
    lib = _build.load()
    launches = dopri_launches(env, cfg_f, cfg_g, s0)
    for kind, launch in launches.items():
        name = f"dopri_{kind}{suffix}"
        pattern = (rf"dopri_{kind}_kernelILb{int(kerr)}ELi"
                   rf"{2 * disk + (k > 0)}E")
        regs = [v for key, v in ptxas_info().items()
                if re.search(pattern, key)]
        census, n_sass = sass_census(pattern)
        blocks = getattr(lib, f"bhgc_dopri_{kind}_occupancy")(
            int(kerr), int(disk), k)
        threads = 1024 // getattr(lib, f"bhgc_dopri_{kind}_blocks")(1024)
        per_ray, rejected = counts[kind]
        lanes, warps = busy_shares(per_ray, threads)
        trips = int(per_ray.sum())
        ms = device_ms(no_grad(launch))
        bound = readings[name]["bound_ms"]
        r, st, sp_st, sp_ld = regs[0] if regs else ("?",) * 4
        log(f"# {tag}: {name}: {r} registers, {st} B stack frame, spills "
            f"{sp_st}/{sp_ld} B; {blocks} blocks of {threads} threads per "
            f"SM; SASS {n_sass} instructions, census {census}; lanes "
            f"{lanes:.4f}, warps {warps:.4f}; {rejected} of {trips} "
            f"ray-trips rejected ({rejected / max(trips, 1):.4f}); device "
            f"{ms:.3f} ms, {ms / bound:.2f} x bound [{name_limit}]")
        readings[name].update(
            registers=r, stack_bytes=st, spill_bytes=[sp_st, sp_ld],
            blocks_per_sm=blocks, threads=threads, sass_instructions=n_sass,
            sass_census=census, busy_lanes=lanes, busy_warps=warps,
            rejected_share=rejected / max(trips, 1),
            device_ms_input_order=ms)
    if kerr:
        dopri_ieee_deviation(tag, f"dopri_fwd{suffix}", env, cfg_f, s0,
                             launches["fwd"], readings)


def dopri_bound(env, cfg_f, cfg_g, s0):
    """The work of dopri_fwd (at ``cfg_f``), dopri_ckpt and dopri_bwd (at
    ``cfg_g``) on the flat initial state ``s0``: operations and bytes by
    kind, trip_counts' replay, and the operations per trip counted (trip,
    sphere quadratics, guard, adjoint trip)."""
    dev = s0.x.device
    n, k = s0.E.numel(), (0 if env.spheres is None
                          else env.spheres.center.shape[0])
    live, guard, counts = trip_counts(env, cfg_f, s0, cfg_g.n_steps)
    trips_f, trips_g = sum(live), sum(live[:cfg_g.n_steps])
    few = rays(s0, torch.arange(64, device=dev))
    few.status = torch.zeros_like(few.status)
    scal = cuda_kernel._scalars(env, cfg_f, dev).detach()
    sph = cuda_kernel._sphere_table(env, dev).detach() if k else None
    ctl = cuda_kernel.controller(cfg_f)
    h = torch.full_like(few.E, 0.5)
    xs, ps = few.x.unbind(-1), few.p.unbind(-1)
    ev = dict(sph=sph, has_disk=env.disk is not None,
              kerr=env.spin is not None)
    trip_ops = ops_per_ray(lambda: adjoint.dopri_trip(
        xs, ps, few.E, h, few.lam, few.status, few.hit_obj, scal, ctl,
        **ev), 64)
    g6 = tuple(torch.ones_like(few.E) for _ in range(6))
    vjp_ops = ops_per_ray(lambda: adjoint.dopri_trip_vjp(
        xs, ps, few.E, h, few.lam, few.status, scal, ctl, g6,
        torch.ones_like(h), **ev), 64)
    quad = guard_ops = 0
    if k:
        y = few.x + 0.1 * few.p
        quad = ops_per_ray(lambda: _sphere_events(env, few.x, y), 64)
        guard_ops = ops_per_ray(lambda: guard_pass(env, few.x, y), 64)
    ops = {"fwd": trips_f * (trip_ops - quad + guard_ops) + sum(guard) * quad,
           "ckpt": trips_g * (trip_ops - quad + guard_ops)
           + sum(guard[:cfg_g.n_steps]) * quad,
           "bwd": trips_g * (trip_ops + vjp_ops)}
    n_seg = -(-cfg_g.n_steps // cuda_kernel.segment(cfg_g.n_steps))
    table = 4 * (10 + 4 * k)
    state_in, state_out = 44 * n, 36 * n
    ckpts = 36 * n_seg * n
    nbytes = {"fwd": state_in + state_out + table,
              "ckpt": state_in + state_out + ckpts + table,
              "bwd": ckpts + 28 * n + 28 * n + 2 * table}
    return (ops, nbytes, (live, guard, counts),
            (trip_ops, quad, guard_ops, vjp_ops))


def phase_dopri_bounds(dev, name_limit, readings):
    """The bound of each Dormand-Prince variant at its main path's inputs
    (the ADAPTIVE_RAYS fan rows for the event-free variants, the RING^2
    Einstein rings for the event variants): the ray-trips of the plain trip
    loop replayed (ACTIVE rays summed), times the operations per trip
    counted (OpCount) on ``adjoint.dopri_trip`` (its sphere quadratics only
    where the forward kernels' guard passes) and per adjoint trip on
    ``adjoint.dopri_trip_vjp``; bytes: each input read once and each output
    written once."""
    for suffix, (env, cfg_f, cfg_g, s0) in dopri_frames(dev).items():
        n, k = s0.E.numel(), (0 if env.spheres is None
                              else env.spheres.center.shape[0])
        (ops, nbytes, (live, guard, counts),
         (trip_ops, quad, guard_ops, vjp_ops)) = dopri_bound(env, cfg_f,
                                                             cfg_g, s0)
        per_ray = counts["ckpt"][0]
        trips_f, trips_g = sum(live), sum(live[:cfg_g.n_steps])
        guarded = sum(guard)
        for kind in ("fwd", "ckpt", "bwd"):
            name = f"dopri_{kind}{suffix}"
            readings[name].update(bound(ops[kind], nbytes[kind]))
            log(f"# phase 26: {name}: {ops[kind]:.4e} operations, "
                f"{nbytes[kind]:.4e} bytes -> bound {readings[name]['bound_ms']:.4f}"
                f" ms by {readings[name]['bound_by']} (device "
                f"{readings[name].get('device_ms', float('nan')):.3f} ms) "
                f"[{name_limit}]")
        log(f"# phase 26: frame dopri{suffix or '_fan'}: {n} rays, "
            f"{trips_f} ray-trips ({trips_f / n:.2f} per ray; the slowest "
            f"ray {len(live)} of {cfg_f.n_steps} trips), {trips_g} within "
            f"{cfg_g.n_steps} trips, {guarded} past the sphere guard; per "
            f"trip {trip_ops} operations (sphere quadratics {quad}, guard "
            f"{guard_ops}), adjoint {vjp_ops}")
        dopri_forward_rows("phase 26", suffix, env, cfg_f, cfg_g, s0, counts,
                           readings, name_limit)
        # dopri_bwd on this frame's checkpoints, in each ray order
        args, ctl_g, kw = dopri_args(env, cfg_g, s0)
        seg = cuda_kernel.segment(cfg_g.n_steps)
        ckpt = lambda kw=dict(kw): cuda_kernel.dopri_ckpt(  # noqa: E731
            *args, seg, ctl_g, **kw)
        with torch.no_grad():
            ck = ckpt()[-1]
        del kw["obj"]
        g = torch.ones_like(s0.x)
        lib = _build.load()
        adjoint_table(
            "phase 26", f"dopri_bwd{suffix}",
            rf"dopri_bwd_kernelILb{int(kw['kerr'])}"
            rf"ELi{2 * kw['has_disk'] + (k > 0)}E", ckpt,
            lambda order: cuda_kernel.dopri_bwd(
                args[0], ck, s0.E, g, g, cfg_g.n_steps, seg, ctl_g,
                tile_order=order, **kw),
            ck[-1], per_ray, seg,
            lib.bhgc_dopri_bwd_occupancy(int(kw["kerr"]),
                                         int(kw["has_disk"]), k),
            1024 // lib.bhgc_dopri_bwd_blocks(1024), readings, name_limit)


# =============================================================================
# The bound of each kernel: operations and bytes of this run's inputs.
# =============================================================================
COUNTED = {
    "add", "sub", "mul", "div", "true_divide", "neg", "sqrt", "rsqrt", "abs",
    "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "gt", "ge", "lt",
    "le", "eq", "ne", "isfinite", "pow", "reciprocal", "__add__", "__radd__",
    "__iadd__", "__sub__", "__rsub__", "__isub__", "__mul__", "__rmul__",
    "__imul__", "__truediv__", "__rtruediv__", "__itruediv__", "__neg__",
    "__pow__", "__rpow__", "__gt__", "__ge__", "__lt__", "__le__", "__eq__",
    "__ne__", "__abs__"}


class OpCount(torch.overrides.TorchFunctionMode):
    """Counts the floating-point operations per ray that a plain PyTorch
    function does on a batch of ``n`` rays: each elementwise arithmetic
    result (+, -, *, /, square root, min, max, comparison, abs) counts one
    per ray, a reduction of k terms k - 1, so a multiply-add counts 2;
    selects (where) and data movement count nothing."""

    def __init__(self, n):
        super().__init__()
        self.n, self.ops = n, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if isinstance(out, torch.Tensor):
            if name in COUNTED:
                self.ops += max(out.numel() // self.n, 1)
            elif name == "sum" and args:
                self.ops += max((args[0].numel() - out.numel()) // self.n, 0)
        return out


def ops_per_ray(fn, n):
    with OpCount(n) as c:
        fn()
    return c.ops


# =============================================================================
# The adjoints (rk4_bwd, dopri_bwd) on their frames: registers, occupancy,
# code size, busy lanes and time in each ray order.
# =============================================================================
# the step-size mode of each power (PMODE in csrc/rk4_step.cuh); 3 for
# any other power
PMODES = {1.0: 0, 1.5: 1, 2.0: 2}


@functools.cache
def ptxas_info(lib=None):
    """{kernel's mangled name: [registers, stack frame bytes, spill stores,
    spill loads]} from the -Xptxas=-v lines of the log of the build of the
    library ``lib`` (the shipped one by default)."""
    lib = _build.library_path() if lib is None else lib
    text = (lib.parent / "build.log").read_text()
    info, name, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = props = m.group(1)
            info[name] = [0, 0, 0, 0]
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and props == name:
            info[name][1:] = map(int, m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            info[name][0] = int(m.group(1))
    return info


@functools.cache
def sass_opcodes():
    """{kernel's mangled name: Counter of its SASS opcodes} of the built
    library, from the toolkit's cuobjdump; None where the toolkit has
    none."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                         capture_output=True, text=True).stdout
    ops, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            ops[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if name and m:
            ops[name][m.group(1)] += 1
    return ops


# The SASS census, by opcode prefix: the special-function unit's
# reciprocals and (reciprocal) square roots, the IEEE division's range
# check, and the calls (the IEEE division's, reciprocal's and square
# root's slow paths are subroutines).
CENSUS = ("MUFU.RCP", "MUFU.RSQ", "MUFU.SQRT", "FCHK", "CALL")


def sass_census(pattern):
    """{census entry: count} summed over the kernels whose mangled name
    matches ``pattern``, and their SASS size; (None, message) without
    cuobjdump."""
    ops = sass_opcodes()
    if ops is None:
        return None, "no cuobjdump"
    census, size = dict.fromkeys(CENSUS, 0), 0
    for k, v in ops.items():
        if re.search(pattern, k):
            size += sum(v.values())
            for prefix in CENSUS:
                census[prefix] += sum(c for op, c in v.items()
                                      if op.startswith(prefix))
    return census, size


def lane_efficiency(counts, seg, perm):
    """The share of an adjoint's lanes that do work: the ray-steps (or
    ray-trips) ``counts`` summed, over 32 times the sum over warps and
    segments of the warp's largest taped count, thread t taking ray
    perm[t].  A ray's taped count in segment s is its steps in it,
    clamp(count - s seg, 0, seg)."""
    c = counts[perm.long()]
    c = torch.cat([c, c.new_zeros(-c.numel() % 32)]).view(-1, 32)
    busy = 0
    for s in range(-(-int(c.max()) // seg)):
        busy += int((c - s * seg).clamp(0, seg).amax(1).sum())
    return float(counts.sum()) / (32 * busy) if busy else 1.0


def adjoint_table(tag, name, pattern, ckpt, launch, live, counts, seg,
                  blocks, threads, readings, name_limit):
    """One row of the adjoints' table for the variant ``name`` (its
    mangled name matches ``pattern``) on its main path's frame: ptxas's
    registers, stack and spills, the resident blocks per SM, the SASS
    size, the share of busy lanes and the device and call times
    (``launch(order)``) in input order and in cost order, with the ray
    order's own device time (``live``: the checkpointing kernel's count)
    and the checkpointing kernel's (``ckpt``) at this segment length."""
    regs = [v for k, v in ptxas_info().items() if re.search(pattern, k)]
    n_sass = sass_census(pattern)[1]
    lanes, ms, call = {}, {}, {}
    for order in ("none", "cost"):
        lanes[order] = lane_efficiency(
            counts, seg, cuda_kernel.ray_order(live, order))
        ms[order] = device_ms(no_grad(lambda: launch(order)))
        call[order] = timed(no_grad(lambda: launch(order)), runs=5)
    ms_order = device_ms(lambda: cuda_kernel.ray_order(live, "cost"))
    ms_ckpt = device_ms(no_grad(ckpt))
    r, st, sp_st, sp_ld = regs[0] if regs else ("?",) * 4
    log(f"# {tag}: {name}: {r} registers, {st} B stack frame, spills "
        f"{sp_st}/{sp_ld} B; {blocks} blocks of {threads} threads "
        f"({blocks * threads // 32} warps) per SM; SASS {n_sass} "
        f"instructions; seg {seg}; lanes busy {lanes['none']:.4f} in input "
        f"order, {lanes['cost']:.4f} in cost order; device {ms['none']:.3f} "
        f"ms in input order, {ms['cost']:.3f} ms in cost order, of which "
        f"the order {ms_order:.3f} ms; call {call['none']:.3f} / "
        f"{call['cost']:.3f} ms; the checkpointing kernel {ms_ckpt:.3f} ms "
        f"device [{name_limit}]")
    readings[name].update(
        registers=r, stack_bytes=st, spill_bytes=[sp_st, sp_ld],
        blocks_per_sm=blocks, threads=threads, sass_instructions=n_sass,
        lanes_input_order=lanes["none"], lanes_cost_order=lanes["cost"],
        device_ms_input_order=ms["none"], device_ms_cost_order=ms["cost"],
        call_ms_input_order=call["none"], call_ms_cost_order=call["cost"],
        order_ms=ms_order, ckpt_device_ms=ms_ckpt)


# =============================================================================
# The forward kernels (rk4_fwd, rk4_ckpt) on their frames: registers,
# occupancy, code and its census, busy lanes and warps, and time.
# =============================================================================
def busy_shares(counts, threads=256):
    """(lanes, warps) busy over a forward kernel's whole run, thread t
    taking ray t in blocks of ``threads``: the ray-steps ``counts`` summed
    over 32 x the sum over warps of the warp's largest count, and that sum
    over the warps a block holds x the sum over blocks of the block's
    largest."""
    per = threads // 32
    c = torch.cat([counts, counts.new_zeros(-counts.numel() % threads)])
    warp = c.view(-1, per, 32).amax(2)
    w, b = int(warp.sum()), int(warp.amax(1).sum())
    return (float(counts.sum()) / (32 * w) if w else 1.0,
            w / (per * b) if b else 1.0)


def ieee_deviation(tag, name, fenv, icfg, s0, launch, readings):
    """What the special-function unit's reciprocals (rk4_step.cuh
    rsqrt_ftz, rcp_ftz) move in rk4_fwd's outputs: ``launch()``'s (x, p,
    lam, status, hit_obj) against the same launch through the IEEE build,
    and each against the plain loop from the flat ``s0``: the rays whose
    status or hit id differ, those a whole step apart (|dlam| of half a
    step or more: one path took a step more to the same end), over the
    others away from b_c (near_b_c, where two correct float32 paths part)
    the largest |dx|, |dp| / max(1, |p|) and |dlam|, and near b_c the
    largest |dlam|."""
    with torch.no_grad():
        fast = launch()
        with _build.built_with(*IEEE):
            ieee = launch()
        sp = cuda_kernel.integrate_plain(fenv, s0, icfg)
    plain = (sp.x, sp.p, sp.lam, sp.status, sp.hit_obj)
    near = near_b_c(fenv, s0)

    def apart(a, b):
        same = (a[3] == b[3]) & (a[4] == b[4])
        dlam = (a[2] - b[2]).abs()
        step = same & (dlam >= 0.5 * icfg.dt)
        keep = same & ~step & ~near
        pscale = b[1].norm(dim=-1, keepdim=True).clamp(min=1.0)
        return dict(
            status_or_hit=int((~same).sum()), step_apart=int(step.sum()),
            dx=masked_max((a[0] - b[0]).abs().amax(-1), keep),
            dp=masked_max(((a[1] - b[1]).abs() / pscale).amax(-1), keep),
            dlam=masked_max(dlam, keep),
            dlam_near_b_c=masked_max(dlam, same & ~step & near))

    differ = int(((fast[0] != ieee[0]).any(-1) | (fast[1] != ieee[1]).any(-1)
                  | (fast[2] != ieee[2]) | (fast[3] != ieee[3])
                  | (fast[4] != ieee[4])).sum())
    dev = {"fast_vs_ieee": apart(fast, ieee),
           "fast_vs_plain": apart(fast, plain),
           "ieee_vs_plain": apart(ieee, plain)}
    log(f"# {tag}: {name} against its IEEE-reciprocal build: {differ} of "
        f"{fast[2].numel()} rays differ in some bit ({int(near.sum())} "
        f"near b_c)")
    for key, d in dev.items():
        log(f"# {tag}: {name} {key}: {d['status_or_hit']} statuses or hit "
            f"ids differ, {d['step_apart']} rays a step apart; elsewhere "
            f"away from b_c max |dx| {d['dx']:.3e}, max "
            f"|dp|/max(1,|p|) {d['dp']:.3e}, max |dlam| {d['dlam']:.3e}; "
            f"near b_c max |dlam| {d['dlam_near_b_c']:.3e}")
    readings[name]["ieee_reciprocals"] = dict(dev, rays_differ=differ)


def forward_rows(tag, suffix, fenv, icfg, s0, per_ray, readings,
                 name_limit):
    """The rows of the forward kernels' table for the variants rk4_fwd and
    rk4_ckpt + ``suffix`` on their main path's frame (``fenv``, ``icfg``,
    the flat ``s0``; ``per_ray``: each ray's steps): ptxas's registers,
    stack and spills, the resident blocks per SM, the SASS size and
    census, the busy lanes and warps, and the device time; for a Kerr
    frame, rk4_fwd against its IEEE-reciprocal build (ieee_deviation)."""
    k = 0 if fenv.spheres is None else fenv.spheres.center.shape[0]
    kw = dict(sph=cuda_kernel._sphere_table(fenv, s0.x.device) if k else None,
              has_disk=fenv.disk is not None, kerr=fenv.spin is not None)
    scal = cuda_kernel._scalars(fenv, icfg, s0.x.device).detach()
    pw, n_steps = float(icfg.dt_power), icfg.n_steps
    seg = cuda_kernel.segment(n_steps)
    args = (scal, s0.x, s0.p, s0.E, s0.lam, s0.status)
    launches = {
        "fwd": lambda: cuda_kernel.rk4_fwd(*args, n_steps, pw,
                                           obj=s0.hit_obj, **kw),
        "ckpt": lambda: cuda_kernel.rk4_ckpt(*args, n_steps, seg, pw,
                                             obj=s0.hit_obj, **kw)}
    lib = _build.load()
    lanes, warps = busy_shares(per_ray)
    for kind, launch in launches.items():
        name = f"rk4_{kind}{suffix}"
        pattern = (rf"rk4_{kind}_kernelILi{PMODES.get(pw, 3)}ELb"
                   rf"{int(kw['kerr'])}ELi{2 * kw['has_disk'] + (k > 0)}E")
        regs = [v for key, v in ptxas_info().items()
                if re.search(pattern, key)]
        census, n_sass = sass_census(pattern)
        blocks = getattr(lib, f"bhgc_rk4_{kind}_occupancy")(
            pw, int(kw["kerr"]), int(kw["has_disk"]), k)
        ms = device_ms(no_grad(launch))
        r, st, sp_st, sp_ld = regs[0] if regs else ("?",) * 4
        log(f"# {tag}: {name}: {r} registers, {st} B stack frame, spills "
            f"{sp_st}/{sp_ld} B; {blocks} blocks of 256 threads per SM; "
            f"SASS {n_sass} instructions, census {census}; lanes "
            f"{lanes:.4f}, warps {warps:.4f}, device {ms:.3f} ms "
            f"[{name_limit}]")
        readings[name].update(
            registers=r, stack_bytes=st, spill_bytes=[sp_st, sp_ld],
            blocks_per_sm=blocks, threads=256, sass_instructions=n_sass,
            sass_census=census, busy_lanes=lanes, busy_warps=warps,
            device_ms_input_order=ms)
    if kw["kerr"]:
        ieee_deviation(tag, f"rk4_fwd{suffix}", fenv, icfg, s0,
                       lambda: launches["fwd"]()[:5], readings)


def guard_pass(env, x, y):
    """Per ray, whether the sphere guard of the forward kernels lets the K
    sphere quadratics of the segment x -> y run (rk4_step.cuh
    segment_events; the band's upper end gains |a| for a Kerr hole)."""
    rb = env.radius(y)
    L = (y - x).norm(dim=-1)
    hi = rb + (env.spin.abs() if env.spin is not None else 0.0)
    ck = env.spheres.center.norm(dim=-1)
    rad = env.spheres.radius
    return ((rb[..., None] - L[..., None] <= ck + rad)
            & (hi[..., None] + L[..., None] >= ck - rad)).any(-1)


def ray_steps(env, cfg, s0):
    """(ray-steps, ray-steps whose sphere guard passes, each ray's steps) of
    the step loop from ``s0``: the ACTIVE rays summed over the steps, as
    the plain loop replays them."""
    steps = guard = 0
    per_ray = torch.zeros_like(s0.E, dtype=torch.int32)
    s = s0
    with torch.no_grad():
        for _ in range(cfg.n_steps):
            act = s.active
            k = int(act.sum())
            if not k:
                break
            steps += k
            per_ray += act.int()
            if env.spheres is not None:
                y, _ = rk4_step(env, s.x, s.p, s.E, _dt_eff(env, cfg, s))
                guard += int((act & guard_pass(env, s.x, y)).sum())
            s = _fixed_step(env, cfg, s)
    return steps, guard, per_ray


def bound(ops, nbytes):
    """The bound readings of work of ``ops`` float32 operations and
    ``nbytes`` bytes: the larger of their times at the card's peak rates
    (PEAK_FLOPS, PEAK_BYTES)."""
    t_ops = ops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, ops=ops, bytes=nbytes)


def rk4_bound(fenv, icfg, s0):
    """The work of rk4_fwd, rk4_ckpt and rk4_bwd on the flat initial state
    ``s0``: operations and bytes by kind, the replayed (ray-steps,
    ray-steps past the sphere guard, each ray's steps) of ray_steps, and
    the operations per ray-step counted (step, sphere quadratics, guard,
    adjoint)."""
    dev = s0.x.device
    n_seg = -(-icfg.n_steps // cuda_kernel.segment(icfg.n_steps))
    n, k = s0.E.numel(), (0 if fenv.spheres is None
                          else fenv.spheres.center.shape[0])
    steps, guard, per_ray = ray_steps(fenv, icfg, s0)
    few = rays(s0, torch.arange(64, device=dev))
    few.status = torch.zeros_like(few.status)
    step_ops = ops_per_ray(lambda: _fixed_step(fenv, icfg, few), 64)
    quad = guard_ops = 0
    if k:
        y = few.x + 0.1 * few.p
        quad = ops_per_ray(lambda: _sphere_events(fenv, few.x, y), 64)
        guard_ops = ops_per_ray(lambda: guard_pass(fenv, few.x, y), 64)
    scal = cuda_kernel._scalars(fenv, icfg, dev).detach()
    sph = cuda_kernel._sphere_table(fenv, dev).detach() if k else None
    g6 = tuple(torch.ones_like(few.E) for _ in range(6))
    adj_ops = ops_per_ray(lambda: adjoint.step_adjoint(
        few.x.unbind(-1), few.p.unbind(-1), few.E, few.status, scal, g6,
        icfg.dt_power, sph=sph, has_disk=fenv.disk is not None,
        kerr=fenv.spin is not None), 64)
    fwd_ops = steps * (step_ops - quad + guard_ops) + guard * quad
    ops = {"fwd": fwd_ops, "ckpt": fwd_ops,
           "bwd": steps * (step_ops + adj_ops)}
    table = 4 * (10 + 4 * k)
    state_in, state_out = 40 * n, 36 * n
    ckpts = 32 * n_seg * n
    nbytes = {"fwd": state_in + state_out + table,
              "ckpt": state_in + state_out + ckpts + table,
              "bwd": ckpts + 28 * n + 28 * n + 2 * table}
    return (ops, nbytes, (steps, guard, per_ray),
            (step_ops, quad, guard_ops, adj_ops))


def phase_bounds(dev, name_limit, readings):
    """The least time the card could take for each kernel's work at the
    main path's inputs: the larger of its operations over the float32 peak
    and its bytes over the memory rate (PEAK_FLOPS, PEAK_BYTES).  The
    ray-steps are the frame's own (ray_steps); the operations per ray-step
    are counted (OpCount) on the plain statement of each variant: the step
    (``_fixed_step``) for rk4_fwd and rk4_ckpt, their sphere quadratics
    only where their guard passes, and the step with its adjoint
    (``adjoint.step_adjoint``) for each taped step of rk4_bwd.  Bytes:
    each input read once and each output written once."""
    cfg = flagship_cfg()
    sky = P.Scene(bh=P.BlackHole.make(mass=0.5, device=dev),
                  background=torch.as_tensor(make_sky(), dtype=torch.float32,
                                             device=dev))
    kenv, kcfg, x0, d0 = kerr_fan(dev)

    def frame(scene, cam):
        fenv, s0 = flagship_rays(scene, cam, cfg, dev)
        return fenv, cfg.integrator, flat_state(s0)

    # the variant's name suffix -> (environment, config, flat initial
    # state) of the main path that runs it
    sky_cam = P.Camera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8),
                            device=dev)
    frames = {"": frame(sky, sky_cam),
              "_events": frame(events_scene(dev), events_cam(dev)),
              "_kerr": (kenv, kcfg, initial_state(kenv, x0, d0)),
              "_kerr_events": frame(events_scene(dev, spin=0.45),
                                    events_cam(dev))}
    for suffix, (fenv, icfg, s0) in frames.items():
        n, k = s0.E.numel(), (0 if fenv.spheres is None
                              else fenv.spheres.center.shape[0])
        (ops, nbytes, (steps, guard, per_ray),
         (step_ops, quad, guard_ops, adj_ops)) = rk4_bound(fenv, icfg, s0)
        scal = cuda_kernel._scalars(fenv, icfg, dev).detach()
        sph = cuda_kernel._sphere_table(fenv, dev).detach() if k else None
        for kind in ("fwd", "ckpt", "bwd"):
            name = f"rk4_{kind}{suffix}"
            readings[name].update(bound(ops[kind], nbytes[kind]))
            log(f"# phase 19: {name}: {ops[kind]:.4e} operations, "
                f"{nbytes[kind]:.4e} bytes -> bound {readings[name]['bound_ms']:.4f}"
                f" ms by {readings[name]['bound_by']} (device "
                f"{readings[name].get('device_ms', float('nan')):.3f} ms) "
                f"[{name_limit}]")
        log(f"# phase 19: frame{suffix or '_sky'}: {n} rays, {steps} "
            f"ray-steps ({steps / n:.2f} per ray), {guard} past the sphere "
            f"guard; per ray-step {step_ops} operations (sphere quadratics "
            f"{quad}, guard {guard_ops}), adjoint {adj_ops}")
        forward_rows("phase 19", suffix, fenv, icfg, s0, per_ray, readings,
                     name_limit)
        # rk4_bwd on this frame's checkpoints, in each ray order
        seg = cuda_kernel.segment(icfg.n_steps)
        kw = dict(sph=sph, has_disk=fenv.disk is not None,
                  kerr=fenv.spin is not None)
        pw = float(icfg.dt_power)
        ckpt = lambda: cuda_kernel.rk4_ckpt(  # noqa: E731
            scal, s0.x, s0.p, s0.E, s0.lam, s0.status, icfg.n_steps, seg, pw,
            obj=s0.hit_obj, **kw)
        with torch.no_grad():
            ck = ckpt()[-1]
        g = torch.ones_like(s0.x)
        lib = _build.load()
        adjoint_table(
            "phase 19", f"rk4_bwd{suffix}",
            rf"rk4_bwd_kernelILi{PMODES.get(pw, 3)}ELb{int(kw['kerr'])}"
            rf"ELi{2 * kw['has_disk'] + (k > 0)}E", ckpt,
            lambda order: cuda_kernel.rk4_bwd(
                scal, ck, s0.E, g, g, icfg.n_steps, seg, pw,
                tile_order=order, **kw),
            ck[-1], per_ray, seg,
            lib.bhgc_rk4_bwd_occupancy(pw, int(kw["kerr"]),
                                       int(kw["has_disk"]), k),
            1024 // lib.bhgc_rk4_bwd_blocks(1024), readings, name_limit)
    # rk4_bwd at the longer segments, where its tape is longest: the sky
    # and the Kerr events frames at 400 and 2000 steps of a proportionally
    # shorter dt (seg 32 and 64)
    for suffix, (scene, cam) in (
            ("", (sky, sky_cam)),
            ("_kerr_events", (events_scene(dev, spin=0.45), events_cam(dev)))):
        for n_steps in (400, 2000):
            icfg = dataclasses.replace(cfg.integrator, n_steps=n_steps,
                                       dt=cfg.integrator.dt * 100 / n_steps)
            fenv, s0 = flagship_rays(
                scene, cam, dataclasses.replace(cfg, integrator=icfg), dev)
            s0 = flat_state(s0)
            k = 0 if fenv.spheres is None else fenv.spheres.center.shape[0]
            kw = dict(sph=cuda_kernel._sphere_table(fenv, dev) if k else None,
                      has_disk=fenv.disk is not None,
                      kerr=fenv.spin is not None)
            scal = cuda_kernel._scalars(fenv, icfg, dev).detach()
            pw, seg = float(icfg.dt_power), cuda_kernel.segment(n_steps)
            ckpt = no_grad(lambda: cuda_kernel.rk4_ckpt(
                scal, s0.x, s0.p, s0.E, s0.lam, s0.status, n_steps, seg, pw,
                obj=s0.hit_obj, **kw))
            ck, g = ckpt()[-1], torch.ones_like(s0.x)
            ms = {o: device_ms(no_grad(lambda: cuda_kernel.rk4_bwd(
                scal, ck, s0.E, g, g, n_steps, seg, pw, tile_order=o, **kw)))
                for o in ("none", "cost")}
            blocks = lib.bhgc_rk4_bwd_occupancy(pw, int(kw["kerr"]),
                                                int(kw["has_disk"]), k)
            log(f"# phase 19: rk4_bwd{suffix} at {n_steps} steps (dt "
                f"{icfg.dt:g}, seg {seg}): {blocks} blocks per SM; rk4_ckpt "
                f"device {device_ms(ckpt):.3f} ms; "
                f"rk4_bwd device {ms['none']:.3f} ms in input order, "
                f"{ms['cost']:.3f} ms in cost order [{name_limit}]")
            del ck


# =============================================================================
# BASELINE config 4: the multisampled animation frame and its outputs.
# =============================================================================
def anim_cfg(backend="auto"):
    """bench.py's make_render_cfg(SIZE, 100, samples=ANIM_SAMPLES)."""
    return dataclasses.replace(flagship_cfg(backend), samples=ANIM_SAMPLES)


def frame_cam(phi, dev):
    """bench_animation's orbit camera: position (25 sin phi, 0, 25 cos
    phi), euler (0, phi, 0), fov 0.8."""
    return P.Camera.make(position=(25.0 * np.sin(phi), 0.0,
                                   25.0 * np.cos(phi)),
                         euler=(0.0, phi, 0.0), fov=(0.8, 0.8), device=dev)


def count_path(readings, path, launches):
    """Record the launches of each kernel variant on a main path of this
    run: the kernels line's ``launches`` of a variant is the sum over its
    main paths, ``launches_by_path`` the parts."""
    for name, n in launches.items():
        readings[name].setdefault("launches_by_path", {})[path] = n


def read_png(path):
    """An 8-bit RGB(A) PNG whose rows have filter 0 (the pure-zlib
    encoder), 1 (Sub) or 2 (Up) -- the native encoder Sub-filters the
    first row and Up-filters the rest -- as a (H, W, C) uint8 array, with
    zlib and numpy alone.  Checks each chunk's CRC."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != (
                zlib.crc32(tag + body) & 0xFFFFFFFF):
            raise AssertionError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            w, h, _, color = struct.unpack(">IIBB", body[:10])
            shape = (h, w, {2: 3, 6: 4}[color])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        shape[0], 1 + shape[1] * shape[2])
    if not np.isin(raw[:, 0], (0, 1, 2)).all():
        raise AssertionError(f"{path}: a row with a filter other than 0-2")
    rows = raw[:, 1:].reshape(shape).astype(np.int64)
    prev = np.zeros(shape[1:], np.int64)
    for y in range(shape[0]):
        if raw[y, 0] == 1:
            rows[y] = np.cumsum(rows[y], axis=0)
        elif raw[y, 0] == 2:
            rows[y] += prev
        rows[y] %= 256
        prev = rows[y]
    return rows.astype(np.uint8)


def plain_kernel_ms(env, s0, cfg):
    """Host-clock ms of the plain versions of the three kernels of
    ``cfg.method`` on the flat state ``s0``, by kind: the early-exit loop
    (fwd), the checkpointed loop's forward under autograd (ckpt) and its
    backward (bwd)."""
    def forward():
        x = s0.x.detach().clone().requires_grad_(True)
        s = dataclasses.replace(s0, x=x)
        return cuda_kernel.integrate_plain(env, s, cfg).x.sum()

    return {"fwd": once_ms(no_grad(lambda: cuda_kernel.integrate_plain(
        env, s0, cfg))), "ckpt": once_ms(forward),
        "bwd": backward_ms(forward)}


def phase_anim_fwd(dev, name_limit, readings):
    """BASELINE config 4's frame 1 at SIZE^2 and ANIM_SAMPLES samples
    through render_image: rk4_fwd's event variant once per sample and
    nothing else, the image against the plain render on the same draws,
    the first sample's final states against the plain loop's; the uint8
    frame against the host quantization of the float frame; the orbit's
    ANIM_FRAMES frames through render_image_u8 written as PNG, one read
    back; times."""
    scene, cam = events_scene(dev), frame_cam(2 * np.pi / ANIM_FRAMES, dev)
    cfg, cfg_plain = anim_cfg(), anim_cfg("torch")
    t_phase = time.perf_counter()
    reset_counts()
    img = P.render_image(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    count_path(readings, "animation frame", launches)
    check(launches == only(rk4_fwd_events=ANIM_SAMPLES),
          f"animation frame launched {launches}, expected rk4_fwd_events "
          f"{ANIM_SAMPLES} times")
    if img.shape != (SIZE, SIZE, 4) or not bool(torch.isfinite(img).all()):
        raise AssertionError("animation frame is not a finite image")
    draws = sample_draws(cfg, dev)
    img_plain, plain_frame_ms = once(no_grad(
        lambda: P.render_image(scene, cam, cfg_plain, draws)))
    image_rule(img, img_plain, f"{SIZE}x{SIZE} x {ANIM_SAMPLES} spp "
               "animation frame, kernel vs plain", FLAGSHIP_MEAN,
               FLAGSHIP_FRAC)
    one = P.render_image(scene, cam, flagship_cfg())
    log(f"# phase 27: the {ANIM_SAMPLES} samples move the frame by mean "
        f"|d| {float((img - one).abs().mean()):.3e} from its pixel centres")
    # the first sample's jittered rays, each held as phase 11 holds the
    # events frame's
    fenv, s0 = flagship_rays(scene, cam, cfg, dev, jitter=draws[0])
    with torch.no_grad():
        s = cuda_kernel.integrate_cuda(fenv, s0, cfg.integrator)
        sp = cuda_kernel.integrate_plain(fenv, s0, cfg.integrator)
    near = near_b_c(fenv, s0)
    sens = ulp_sensitive(fenv, cfg.integrator, s0, sp)
    log(f"# phase 27: sample 0: {int(near.sum())} rays near b_c, "
        f"{int((sens & ~near).sum())} more that one ulp of their start moves "
        f"by > {ULP_SHARE:g} of a tolerance (ulp_sensitive)")
    e, n, n_edge = compare_events(
        fenv, cfg.integrator, flat_state(s0), flat_state(s), flat_state(sp),
        f"{SIZE}x{SIZE} animation frame, sample 0",
        (near | sens).reshape(-1))
    r = readings["rk4_fwd_events"]
    r.update(max_abs_err=max(r.get("max_abs_err", 0.0), e),
             rays_aligned=r.get("rays_aligned", 0) + n,
             edge_rays=r.get("edge_rays", 0) + n_edge)

    # the uint8 frame: the host's quantization of the float frame
    host_img = img.cpu().numpy()
    u8 = P.render_image_u8(scene, cam, cfg).cpu().numpy()
    host = (np.clip(host_img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    same_u8 = np.array_equal(u8, host)
    rgb = host_img[..., :3]
    tm = np.concatenate([rgb / (1.0 + rgb), host_img[..., 3:]], -1)
    host_t = (np.clip(tm, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    u8t = P.render_image_u8(scene, cam, cfg, tonemap=True).cpu().numpy()
    levels = int(np.abs(u8t.astype(int) - host_t.astype(int)).max())
    log(f"# phase 27: render_image_u8 "
        + ("equals" if same_u8 else "DIFFERS from")
        + f" the host quantization of the float frame; with the tonemap "
        f"within {levels} level(s)")
    check(same_u8, "render_image_u8 differs from the host quantization")
    check(levels <= 1, f"tonemapped uint8 frame {levels} levels off")

    # the orbit: ANIM_FRAMES frames through render_image_u8, as PNG
    out = ROOT / "build" / "animation"
    out.mkdir(parents=True, exist_ok=True)
    paths, frames = [], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(ANIM_FRAMES):
        fu8 = P.render_image_u8(scene, frame_cam(2 * np.pi * f / ANIM_FRAMES,
                                                 dev), cfg)
        paths.append(write_png(str(out / f"frame_{f:04d}.png"), fu8))
        if f == 1:
            frames[f] = fu8.cpu().numpy()
    loop_s = time.perf_counter() - t0
    back = read_png(paths[1])
    check(np.array_equal(back, frames[1]) and np.array_equal(back, u8),
          "a PNG frame does not read back as the uint8 frame")
    size_mb = sum(Path(q).stat().st_size for q in paths) / 1e6
    ms = {
        "float frame": timed(no_grad(lambda: P.render_image(scene, cam,
                                                            cfg)), runs=5),
        "uint8 frame, on the host": timed(
            lambda: P.render_image_u8(scene, cam, cfg).cpu(), runs=5),
        "PNG write": timed(lambda: write_png(paths[1], back), runs=3),
        "float frame (plain)": plain_frame_ms,
    }
    fps = ANIM_FRAMES / loop_s
    for what, v in ms.items():
        log(f"# phase 27: {what} {SIZE}x{SIZE} x {ANIM_SAMPLES} spp: "
            f"median {v:.3f} ms [{name_limit}]")
    log(f"# phase 27: {ANIM_FRAMES} orbit frames through render_image_u8 "
        f"and write_png ({size_mb:.1f} MB) in "
        f"{loop_s:.3f} s: {fps:.3f} frames/s; frame 1 read back equal "
        f"[{name_limit}]")
    readings["animation"] = dict(
        frame_ms=ms["float frame"], u8_frame_ms=ms["uint8 frame, on the host"],
        png_ms=ms["PNG write"], frames_per_s=fps,
        plain_frame_ms=ms["float frame (plain)"])
    log(f"# phase 27: done in {time.perf_counter() - t_phase:.1f} s")


def phase_anim_grad(dev, name_limit, readings):
    """The gradient of mean(img[..., :3]^2) of config 4's frame 1 to the
    mass, the camera position and the sky: rk4_ckpt's and rk4_bwd's event
    variants, the shading's forward and backward and its texture scatter
    (the sky) once per sample each, rk4_fwd and tex_bwd never;
    against the plain path on the same draws, the sky whole and the mass
    and camera on the pixels calm in every sample (frame_parts); the sky
    cotangents of the samples add up; two runs; times, the device busy
    share, each kernel's device ms per sample and its bound, K2's
    checkpoint bytes."""
    scene, cam = events_scene(dev), frame_cam(2 * np.pi / ANIM_FRAMES, dev)
    cfg, cfg_plain = anim_cfg(), anim_cfg("torch")
    icfg = cfg.integrator
    t_phase = time.perf_counter()
    reset_counts()
    gk = render_grads(scene, cam, cfg)
    torch.cuda.synchronize()
    launches, shaded = read_counts(), read_shading()
    count_path(readings, "animation step", {**launches, **shaded})
    check(launches == only(rk4_ckpt_events=ANIM_SAMPLES,
                           rk4_bwd_events=ANIM_SAMPLES)
          and shaded == shading(fwd=ANIM_SAMPLES, bwd=ANIM_SAMPLES,
                                tex=ANIM_SAMPLES),
          f"animation step launched {launches}, {shaded}, expected "
          f"rk4_ckpt_events, rk4_bwd_events, shade_fwd, shade_bwd and "
          f"shade_tex (the sky) {ANIM_SAMPLES} times each")
    for g in gk:
        check(bool(torch.isfinite(g).all()), "animation gradient not finite")
    gp, plain_ms = once(lambda: render_grads(scene, cam, cfg_plain))
    errs = compare_render_grads(gk, gp, f"{SIZE}x{SIZE} x {ANIM_SAMPLES} spp "
                                "animation frame, kernel vs plain (mass, "
                                "camera: a reading)", float("inf"))
    check(errs[2] <= TOL_EVENTS_GRAD,
          f"animation sky gradient outside {TOL_EVENTS_GRAD:g}")
    # the calm pixels: calm in every sample, each sample's texel flips
    # counted and capped as phase 11's
    draws = sample_draws(cfg, dev)
    calm = torch.ones((SIZE, SIZE), dtype=torch.bool, device=dev)
    flips_per_sample, samples = [], []
    for k in range(ANIM_SAMPLES):
        fenv, s0 = flagship_rays(scene, cam, cfg, dev, jitter=draws[k])
        with torch.no_grad():
            s = cuda_kernel.integrate_cuda(fenv, s0, icfg)
            sp = cuda_kernel.integrate_plain(fenv, s0, icfg)
        parts, flips = frame_parts(scene, fenv, icfg, s0, s, sp)
        c = torch.ones_like(flips)
        for m in parts.values():
            c &= ~m
        flips_per_sample.append(int((c & flips).sum()))
        calm &= c & ~flips
        samples.append((fenv, flat_state(s0)))
        del s, sp
    check(max(flips_per_sample) <= MAX_TEXEL_FLIPS,
          f"animation frame: {flips_per_sample} texel flips among the calm "
          f"pixels of the samples (at most {MAX_TEXEL_FLIPS} each)")
    log(f"# grad [animation frame] calm in every sample: {int(calm.sum())} "
        f"pixels (texel flips left out per sample {flips_per_sample})")
    calm_errs = compare_render_grads(
        render_grads(scene, cam, cfg, calm.float()),
        render_grads(scene, cam, cfg_plain, calm.float()),
        f"{SIZE}x{SIZE} x {ANIM_SAMPLES} spp animation frame, calm pixels, "
        "kernel vs plain", TOL_CALM_GRAD)

    # a linear loss: the frame's sky cotangent is the mean of its samples'
    def sky_grad(loss):
        bg = scene.background.detach().clone().requires_grad_(True)
        loss(dataclasses.replace(scene, background=bg)).backward()
        return bg.grad

    whole = sky_grad(lambda sc: P.render_image(sc, cam, cfg)[..., :3].mean())
    parts_sum = sum(sky_grad(lambda sc, k=k: render_sample(
        sc, cam, cfg, draws[k]).mean()) for k in range(ANIM_SAMPLES))
    add_err = rel_err(whole, parts_sum / ANIM_SAMPLES)
    log(f"# grad [animation frame] the sky cotangent of mean(img) against "
        f"the mean of its {ANIM_SAMPLES} samples': {add_err:.3e}")
    check(add_err <= 1e-5, "the samples' sky cotangents do not add up")
    # two runs of the whole gradient
    gk2 = render_grads(scene, cam, cfg)
    same = [bool(torch.equal(a, b)) for a, b in zip(gk, gk2)]
    sky_spread = rel_err(gk2[2], gk[2])
    log(f"# determinism: two {ANIM_SAMPLES}-sample gradients: mass "
        + ("equal" if same[0] else "differs") + ", camera "
        + ("equal" if same[1] else "differs") + ", sky "
        + ("equal bit for bit" if same[2] else
           f"spread max|d|/max|g| = {sky_spread:.3e}"))

    # times and the device's busy share
    step = lambda: render_grads(scene, cam, cfg)  # noqa: E731
    wall = timed(step, runs=5)
    log(f"# phase 28: animation forward+backward step {SIZE}x{SIZE} x "
        f"{ANIM_SAMPLES} spp: median {wall:.3f} ms, plain {plain_ms:.3f} ms "
        f"[{name_limit}]")
    busy_ms, busy = step_profile(step, wall, "phase 28: animation "
                                 "forward+backward step", name_limit)
    # each kernel on each sample's rays: device ms and bound
    kw = None
    dev_ms = {k: [] for k in ("fwd", "ckpt", "bwd")}
    bounds = {k: [] for k in ("fwd", "ckpt", "bwd")}
    ckpt_bytes = 0
    for fenv, s0 in samples:
        scal = cuda_kernel._scalars(fenv, icfg, dev)
        seg = cuda_kernel.segment(icfg.n_steps)
        kw = event_kw(fenv, s0)
        args = (scal, s0.x, s0.p, s0.E, s0.lam, s0.status)
        ckpt = no_grad(lambda: cuda_kernel.rk4_ckpt(*args, icfg.n_steps, seg,
                                                    1.5, **kw))
        ck = ckpt()[-1]
        ckpt_bytes += sum(t.numel() * t.element_size() for t in ck)
        g = torch.ones_like(s0.x)
        dev_ms["fwd"].append(device_ms(no_grad(lambda: cuda_kernel.rk4_fwd(
            *args, icfg.n_steps, 1.5, **kw))))
        dev_ms["ckpt"].append(device_ms(ckpt))
        dev_ms["bwd"].append(device_ms(no_grad(lambda: cuda_kernel.rk4_bwd(
            scal, ck, s0.E, g, g, icfg.n_steps, seg, 1.5, sph=kw["sph"],
            has_disk=True, kerr=False))))
        ops, nbytes, (steps, _, _), _ = rk4_bound(fenv, icfg, s0)
        for kind in bounds:
            bounds[kind].append(bound(ops[kind], nbytes[kind])["bound_ms"])
        del ck
    kernel_plain = plain_kernel_ms(*samples[0], icfg)
    for kind in ("fwd", "ckpt", "bwd"):
        name = f"rk4_{kind}_events"
        readings[name]["animation"] = dict(
            device_ms_per_sample=statistics.mean(dev_ms[kind]),
            bound_ms_per_sample=statistics.mean(bounds[kind]),
            plain_ms_per_sample=kernel_plain[kind])
        log(f"# phase 28: {name} per sample: device "
            + ", ".join(f"{v:.3f}" for v in dev_ms[kind]) + " ms, bound "
            + ", ".join(f"{v:.4f}" for v in bounds[kind])
            + f" ms; its plain version on sample 0 {kernel_plain[kind]:.3f} "
            "ms "
            f"[{name_limit}]")
    readings.setdefault("animation", {}).update(
        step_ms=wall, step_plain_ms=plain_ms, device_busy_ms=busy_ms,
        device_busy=busy, ckpt_bytes=ckpt_bytes)
    log(f"# phase 28: rk4_ckpt's checkpoints of the {ANIM_SAMPLES} samples, "
        f"held for autograd: {ckpt_bytes / 2**20:.1f} MiB per step")
    readings["rk4_bwd_events"]["animation"].update(
        render_grad_err=max([errs[2]] + calm_errs),
        sky_sum_err=add_err, gradients_equal=same)
    log(f"# phase 28: done in {time.perf_counter() - t_phase:.1f} s")


def phase_anim_outputs(dev, readings):
    """render_progressive on config 4's frame 1: at ANIM_SAMPLES samples its
    last yield equals render_image within 1e-5; at one sample its 16
    bands, one rk4_fwd launch each, equal the whole frame's rows bit for
    bit.  render_stats and debug_rays (a square crop of SIZE / 16 pixels a
    side right of the frame's centre) on the card against the plain path: counts and
    statuses equal but for the edge rays compare_events admits."""
    scene, cam = events_scene(dev), frame_cam(2 * np.pi / ANIM_FRAMES, dev)
    cfg, one = anim_cfg(), flagship_cfg()
    t_phase = time.perf_counter()
    with torch.no_grad():
        img = P.render_image(scene, cam, cfg)
        frames = list(render_progressive(scene, cam, cfg))
        d_last = float((frames[-1][1] - img).abs().max())
        full = P.render_image(scene, cam, one)
        reset_counts()
        bands = list(render_progressive(scene, cam, one, row_bands=16))
        torch.cuda.synchronize()
        launches = read_counts()
    band = -(-SIZE // 16)
    bad = [i for i, f in bands
           if not torch.equal(f[i * band:(i + 1) * band],
                              full[i * band:(i + 1) * band])]
    log(f"# phase 29: render_progressive at {ANIM_SAMPLES} samples: "
        f"{len(frames)} yields, the last within {d_last:.3e} of render_image;"
        f" at one sample {len(bands)} bands ({launches}), "
        + ("each equal to the frame's rows bit for bit" if not bad
           else f"bands {bad} DIFFER from the frame's rows"))
    check(len(frames) == ANIM_SAMPLES and d_last <= 1e-5,
          "render_progressive's last sample is not render_image's image")
    check(not bad and len(bands) == 16
          and launches == only(rk4_fwd_events=16),
          "render_progressive's bands differ from the frame")
    check(torch.equal(bands[-1][1], full), "the last band's frame differs")

    plain = flagship_cfg("torch")
    sk, sp = render_stats(scene, cam, one), render_stats(scene, cam, plain)
    diff = {k: sk["status"][k] - sp["status"][k] for k in sk["status"]}
    moved = sum(abs(v) for v in diff.values())
    log(f"# phase 29: render_stats kernel {sk['status']} vs plain; "
        f"differences {diff}; lam_mean {sk['lam_mean']:.6f} vs "
        f"{sp['lam_mean']:.6f}, lam_max {sk['lam_max']:.4f} vs "
        f"{sp['lam_max']:.4f}")
    check(sk["rays_total"] == sp["rays_total"] == SIZE * SIZE
          and moved <= 2 * MAX_EDGE
          and abs(sk["lam_mean"] - sp["lam_mean"]) <= 1e-3,
          "render_stats differs from the plain path's")
    w = SIZE // 16
    dcfg = dataclasses.replace(one, mark_x_min=10 * w, mark_x_max=11 * w - 1,
                               mark_y_min=15 * w // 2,
                               mark_y_max=17 * w // 2 - 1)
    rk = debug_rays(scene, cam, dcfg)
    rp = debug_rays(scene, cam, dataclasses.replace(
        dcfg, integrator=plain.integrator))
    flip = (rk["status"] != rp["status"]) | (rk["hit_obj"] != rp["hit_obj"])
    same_rays = all(np.array_equal(rk[k], rp[k])
                    for k in ("ys", "xs", "origin", "direction"))
    text_k = format_debug_string(rk).splitlines()
    text_p = format_debug_string(rp).splitlines()
    layout = len(text_k) == len(text_p) == w * w and all(
        a.split(" end_loc=")[0] == b.split(" end_loc=")[0]
        for a, b in zip(text_k, text_p))
    hist = np.bincount(rp["status"], minlength=8).tolist()
    log(f"# phase 29: debug_rays over {w}x{w} pixels: launch records "
        + ("equal" if same_rays else "DIFFER") + f", {int(flip.sum())} "
        f"statuses or hit ids differ; statuses {hist}; the text's layout "
        + ("equal" if layout else "DIFFERS"))
    check(same_rays and layout and int(flip.sum()) <= MAX_EDGE,
          "debug_rays differs from the plain path's")
    readings.setdefault("animation", {})["progressive_last_err"] = d_last
    log(f"# phase 29: done in {time.perf_counter() - t_phase:.1f} s")


# =============================================================================
# Massive particles: launch(..., time_like=True) through K1-K6.
# =============================================================================
def particle_fan(n, dev, seed=0, mass=0.5):
    """n massive particles about a hole of mass ``mass`` in random orbital
    planes: circular orbits at r = 4-20 M (dx/dtau = r Omega u^t along the
    tangent, Omega^2 = M / r^3, u^t = 1 / sqrt(1 - 3M/r)), bound eccentric
    orbits at perihelion (tests/test_timelike.py's p~ = 20, e = 0.2),
    plunging and escaping particles, and a tenth inside the horizon.
    Returns (x0, dx/dtau)."""
    M = mass
    rng = np.random.default_rng(seed)
    kind = rng.choice(5, size=n, p=[0.4, 0.2, 0.15, 0.15, 0.1])
    n_hat = rng.normal(size=(n, 3))
    n_hat /= np.linalg.norm(n_hat, axis=-1, keepdims=True)
    a = rng.normal(size=(n, 3))
    t_hat = a - np.sum(a * n_hat, -1, keepdims=True) * n_hat
    t_hat /= np.linalg.norm(t_hat, axis=-1, keepdims=True)
    r = rng.uniform(4.0, 20.0, n) * M
    speed = r * np.sqrt(M / r ** 3) / np.sqrt(1.0 - 3.0 * M / r)
    pt, e = 20.0, 0.2
    ecc = kind == 1
    r[ecc] = pt * M / (1 + e)
    speed[ecc] = M * pt / np.sqrt(pt - 3 - e * e) / r[ecc]
    v = speed[:, None] * t_hat
    for k, lo, hi, sign, vr, vt in ((2, 4.0, 15.0, -1.0, (0.3, 1.0), 0.1),
                                    (3, 6.0, 20.0, 1.0, (0.6, 2.0), 0.3)):
        m = kind == k
        r[m] = rng.uniform(lo, hi, int(m.sum()))
        v[m] = (sign * rng.uniform(*vr, (int(m.sum()), 1)) * n_hat[m]
                + rng.uniform(0.0, vt, (int(m.sum()), 1)) * t_hat[m])
    m = kind == 4
    r[m] = rng.uniform(0.05, 0.95, int(m.sum())) * 2 * M
    v[m] = rng.normal(size=(int(m.sum()), 3)) * 0.5
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return f(r[:, None] * n_hat), f(v)


def particle_state(env, x0, v0):
    """The state ``launch(..., time_like=True)`` integrates."""
    p0, E0 = timelike_init(x0, v0, env.mass, env.spin)
    s0 = states.init_state(x0.contiguous(), p0, E0)
    s0.status = s0.status.masked_fill(env.radius(x0) <= env.r_capture,
                                      states.INSIDE_HORIZON)
    return s0


def near_separatrix(env, s0):
    """Particles of the Schwarzschild hole ``env`` whose energy E and
    angular momentum L = |x cross p| (both conserved) put E^2 within
    SEP_BAND of the peak of their effective potential (1 - 2M/r)(1 +
    L^2/r^2), at r_u = (L^2 - sqrt(L^4 - 12 L^2 M^2)) / 2M: near the
    unstable circular orbit that separates falling in from getting away,
    where each orbit multiplies a rounding difference, as b_c does for
    photons."""
    m = env.mass.double()
    E = s0.E.double()
    L2 = torch.linalg.cross(s0.x, s0.p, dim=-1).double().pow(2).sum(-1)
    has_peak = L2 > 12.0 * m * m
    ru = (L2 - (L2 * L2 - 12.0 * L2 * m * m).clamp_min(0.0).sqrt()) / (
        2.0 * m)
    ru = torch.where(has_peak, ru, torch.ones_like(ru))
    vmax = (1.0 - 2.0 * m / ru) * (1.0 + L2 / (ru * ru))
    return has_peak & ((E * E - vmax).abs() < SEP_BAND)


def compare_particles(env, cfg, s0, a, b, what):
    """Kernel state ``a`` against plain state ``b`` of massive particles
    from ``s0``: every output finite, statuses equal; the particles near
    their separatrix (near_separatrix) to lam within half a step, the
    others to x and lam within TOL_X and p within TOL_P of max(1, |p|),
    those that end a step apart on a boundary aligned (step_apart).  (No
    final directions: a particle's end is no sky lookup.)  Returns the
    largest error and the rays aligned."""
    for s in (a, b):
        if not all(bool(torch.isfinite(t).all()) for t in (s.x, s.p, s.lam)):
            raise AssertionError(f"{what}: a non-finite output")
    n_bad = int((a.status != b.status).sum())
    if n_bad:
        raise AssertionError(f"{what}: {n_bad} statuses differ")
    near = near_separatrix(env, s0)
    dl_near = (a.lam - b.lam).abs()[near]
    jump = near & ((a.lam - b.lam).abs() >= 0.5 * cfg.dt)
    _, _, n_jump = step_apart(env, cfg, rays(a, jump), rays(b, jump))
    a, b, n_apart = step_apart(env, cfg, rays(a, ~near), rays(b, ~near))
    dx = float((a.x - b.x).abs().max())
    dl = float((a.lam - b.lam).abs().max())
    dp = float(((a.p - b.p).abs()
                / b.p.norm(dim=-1, keepdim=True).clamp_min(1.0)).max())
    dln = float(dl_near[dl_near < 0.5 * cfg.dt].max()) if bool(
        (dl_near < 0.5 * cfg.dt).any()) else 0.0
    log(f"# particles [{what}] n={s0.E.numel()} statuses equal, "
        f"{n_apart + n_jump} end a step apart at a boundary; away from the "
        f"separatrix max|dx|={dx:.3e} max|dp|={dp:.3e} max|dlam|={dl:.3e}; "
        f"{int(near.sum())} near it max|dlam|={dln:.3e}")
    if not (dx <= TOL_X and dl <= TOL_X and dp <= TOL_P):
        raise AssertionError(f"{what}: outside tolerance (x/lam {TOL_X}, p "
                             f"{TOL_P})")
    return max(dx, dp, dl), n_apart + n_jump


def particle_cfgs():
    """(RK4 config and its lam_max, Dormand-Prince forward and gradient
    configs and their lam_max) of the timelike fan: the flagship schedule,
    bound orbits still in flight after 100 steps; bench.py's adaptive
    tolerances at max_step 4 until bound orbits end on the budget."""
    return ((flagship_cfg().integrator, 1000.0),
            (adaptive_cfg(2000, 4.0), adaptive_cfg(120, 4.0), 60.0))


def particle_grads(env, x0, v0, cfg, kernel):
    """The final state and the cotangents of the initial velocities and
    the mass for sum(x^2) over the particles that neither fall in nor
    err, through launch(..., time_like=True) on the kernels or the plain
    loop."""
    mass = env.mass.detach().clone().requires_grad_(True)
    e = dataclasses.replace(env, mass=mass)
    v = v0.detach().clone().requires_grad_(True)
    c = dataclasses.replace(cfg, backend="auto" if kernel else "torch")
    s = P.launch(e, x0, v, c, time_like=True)
    keep = (s.status != states.CAPTURED) & (s.status != states.ERROR)
    torch.where(keep[..., None], s.x * s.x, 0.0).sum().backward()
    return s, v.grad, mass.grad


def phase_timelike(dev, name_limit, readings):
    """PARTICLES massive particles (particle_fan) through launch(...,
    time_like=True): rk4_fwd against the plain loop and Hh = -1/2 along
    its particles still in flight; rk4_ckpt = rk4_fwd bit for bit and its
    checkpoint rows against the plain loop; rk4_bwd's cotangents of the
    initial velocities and the mass against autograd of the plain loop;
    dopri_fwd against the plain trip loop (statuses on DOPRI_AGREE, the
    same-trip particles to the state tolerances, every particle in
    flight by its angular momentum and Hh); dopri_ckpt = dopri_fwd and its
    rows; dopri_bwd's cotangents (the median over the same-trip particles,
    the mass); no NaN anywhere, the inside-horizon band's cotangents zero;
    each kernel's call and device ms and bound."""
    t_phase = time.perf_counter()
    (rcfg, r_lam), (dcfg_f, dcfg_g, d_lam) = particle_cfgs()
    x0, v0 = particle_fan(PARTICLES, dev)
    errs, out = {}, {}

    # RK4: rk4_fwd
    env = dataclasses.replace(fan_env(dev), lam_max=torch.tensor(r_lam,
                                                                 device=dev))
    reset_counts()
    with torch.no_grad():
        sk = P.launch(env, x0, v0, rcfg, time_like=True)
    torch.cuda.synchronize()
    launches = read_counts()
    count_path(readings, "timelike fan", launches)
    check(launches == only(rk4_fwd=1),
          f"timelike forward launched {launches}, expected rk4_fwd once")
    with torch.no_grad():
        sp = P.launch(env, x0, v0, dataclasses.replace(rcfg, backend="torch"),
                      time_like=True)
    inside = sk.status == states.INSIDE_HORIZON
    check(bool(inside.any()) and torch.equal(sk.x[inside], x0[inside]),
          "inside-horizon particles moved")
    s0 = flat_state(particle_state(env, x0, v0))
    near = near_separatrix(env, s0)
    errs["rk4_fwd"], aligned = compare_particles(env, rcfg, s0, sk, sp,
                                                 f"timelike fan {PARTICLES}")
    flying = sk.status == states.ACTIVE
    drift = float((hamiltonian(sk.x, sk.p, sk.E, env.mass)[flying] + 0.5)
                  .abs().max())
    hist = torch.bincount(sk.status.long(), minlength=8).tolist()
    log(f"# phase 30: rk4_fwd: statuses {hist}; Hh + 1/2 of the "
        f"{int(flying.sum())} particles in flight within {drift:.3e} "
        f"(limit {H_DRIFT:g})")
    check(drift <= H_DRIFT and int(flying.sum()) > PARTICLES // 3,
          "the super-Hamiltonian drifted along rk4_fwd's particles")

    # rk4_ckpt: rk4_fwd bit for bit, its rows against the plain loop
    with torch.no_grad():
        fwd, fin, ck = run_ckpt(env, rcfg, s0)
        seg = cuda_kernel.segment(rcfg.n_steps)
        _, rows = cuda_kernel.integrate_ckpt_plain(env, s0, rcfg, seg)
    same = all(torch.equal(a, b) for a, b in zip(fwd, fin))
    check(same, "timelike: rk4_ckpt's final state differs from rk4_fwd's")
    keep = (fin[2] - sp.lam).abs() <= TOL_X
    errs["rk4_ckpt"] = max(compare_particles(
        env, rcfg, rays(s0, keep), rays(ckpt_rows(ck, k, s0), keep),
        rays(row, keep), f"timelike fan, checkpoint row {k}")[0]
        for k, row in enumerate(rows))
    log(f"# phase 30: rk4_ckpt " + ("equals rk4_fwd bit for bit" if same
                                    else "DIFFERS from rk4_fwd")
        + f"; {len(rows)} rows of seg {seg} agree; " + live_equal(ck, "fan"))
    del ck

    # rk4_bwd: the cotangents of the initial velocities and the mass
    reset_counts()
    out_k, gk, mk = particle_grads(env, x0, v0, rcfg, True)
    torch.cuda.synchronize()
    launches = read_counts()
    count_path(readings, "timelike fan", launches)
    check(launches == only(rk4_ckpt=1, rk4_bwd=1),
          f"timelike gradient launched {launches}")
    out_p, gp, mp = particle_grads(env, x0, v0, rcfg, False)
    ok = ((out_k.lam - out_p.lam).abs() <= TOL_X) & ~near
    gerr = rel_err(gk[ok], gp[ok])
    merr = abs(float(mk) / float(mp) - 1.0)
    zero = float(gk[inside].abs().max())
    log(f"# grad [timelike fan, rk4] velocity cotangents away from the "
        f"separatrix {gerr:.3e} (max |d| / max |plain|; near it "
        f"{rel_err(gk[near], gp[near]):.3e}, a reading), mass {float(mk):.7g} vs {float(mp):.7g} (rel "
        f"{merr:.3e}); inside-horizon cotangents {zero:g}; finite: "
        f"{bool(torch.isfinite(gk).all())}")
    check(bool(torch.isfinite(gk).all()) and zero == 0.0
          and gerr <= TOL_GRAD and merr <= TOL_GRAD_MASS,
          f"timelike rk4_bwd outside ({TOL_GRAD:g}, mass {TOL_GRAD_MASS:g})")
    errs["rk4_bwd"] = max(gerr, merr)

    # Dormand-Prince: dopri_fwd
    env = dataclasses.replace(fan_env(dev), lam_max=torch.tensor(d_lam,
                                                                 device=dev))
    reset_counts()
    with torch.no_grad():
        sk = P.launch(env, x0, v0, dcfg_f, time_like=True)
    torch.cuda.synchronize()
    launches = read_counts()
    count_path(readings, "timelike fan", launches)
    check(launches == only(dopri_fwd=1),
          f"timelike adaptive forward launched {launches}")
    with torch.no_grad():
        sp = P.launch(env, x0, v0, dataclasses.replace(dcfg_f,
                                                       backend="torch"),
                      time_like=True)
    s0 = flat_state(particle_state(env, x0, v0))
    errs["dopri_fwd"] = compare_adaptive_particles(env, s0, sk, sp,
                                                   dcfg_f.max_step,
                                                   f"timelike fan {PARTICLES}")

    # dopri_ckpt: dopri_fwd bit for bit, its rows against the plain loop
    args, ctl, kw = dopri_args(env, dcfg_g, s0)
    seg = cuda_kernel.segment(dcfg_g.n_steps)
    with torch.no_grad():
        fwd = cuda_kernel.dopri_fwd(*args, ctl, **kw)
        *fin, ck = cuda_kernel.dopri_ckpt(*args, seg, ctl, **kw)
        _, rows, hs = cuda_kernel.integrate_adaptive_ckpt_plain(
            env, s0, dcfg_g, seg)
    same = all(torch.equal(a, b) for a, b in zip(fwd, fin))
    check(same, "timelike: dopri_ckpt's final state differs from dopri_fwd's")
    worst_st, worst_dx = 1.0, 0.0
    for k, row in enumerate(rows):
        cx, cp, ch, clam, cst = (t[k] for t in ck[:5])
        worst_st = min(worst_st, float((cst == row.status).float().mean()))
        keep = ((clam - row.lam).abs() <= SAME_TRIP) & (
            row.status != states.CAPTURED) & ~near
        worst_dx = max(worst_dx, masked_max((cx - row.x).abs().amax(-1),
                                            keep))
    log(f"# phase 30: dopri_ckpt " + ("equals dopri_fwd bit for bit" if same
                                      else "DIFFERS from dopri_fwd")
        + f"; {len(rows)} rows of seg {seg}: statuses equal on >= "
        f"{worst_st:.6f}, same-trip particles' max|dx| {worst_dx:.3e}; "
        + live_equal(ck, "fan"))
    check(worst_st >= DOPRI_AGREE and worst_dx <= TOL_X,
          "timelike dopri_ckpt rows outside tolerance")
    errs["dopri_ckpt"] = worst_dx
    del ck

    # dopri_bwd
    reset_counts()
    out_k, gk, mk = particle_grads(env, x0, v0, dcfg_g, True)
    torch.cuda.synchronize()
    launches = read_counts()
    count_path(readings, "timelike fan", launches)
    check(launches == only(dopri_ckpt=1, dopri_bwd=1),
          f"timelike adaptive gradient launched {launches}")
    out_p, gp, mp = particle_grads(env, x0, v0, dcfg_g, False)
    same = ((out_k.status == out_p.status)
            & ((out_k.lam - out_p.lam).abs() <= SAME_TRIP) & ~inside & ~near)
    med = float(ray_rel(gk, gp)[same].median())
    merr = abs(float(mk) / float(mp) - 1.0)
    zero = float(gk[inside].abs().max())
    log(f"# grad [timelike fan, Dormand-Prince, {dcfg_g.n_steps} trips] "
        f"{int(same.sum())} particles on the same trips: velocity "
        f"cotangents median |d| / |plain| {med:.3e}; mass {float(mk):.7g} "
        f"vs {float(mp):.7g} (rel {merr:.3e}); inside-horizon cotangents "
        f"{zero:g}; finite: {bool(torch.isfinite(gk).all())}")
    check(bool(torch.isfinite(gk).all()) and zero == 0.0
          and med <= TOL_DOPRI_GRAD and merr <= TOL_DOPRI_GRAD_SCALAR,
          f"timelike dopri_bwd outside ({TOL_DOPRI_GRAD:g} median, mass "
          f"{TOL_DOPRI_GRAD_SCALAR:g})")
    errs["dopri_bwd"] = max(med, merr)

    # times and bounds of each kernel on the fan
    renv = dataclasses.replace(fan_env(dev), lam_max=torch.tensor(
        r_lam, device=dev))
    r0 = flat_state(particle_state(renv, x0, v0))
    rscal = cuda_kernel._scalars(renv, rcfg, dev)
    rseg = cuda_kernel.segment(rcfg.n_steps)
    rargs = (rscal, r0.x, r0.p, r0.E, r0.lam, r0.status)
    g = torch.ones_like(r0.x)
    with torch.no_grad():
        rck = cuda_kernel.rk4_ckpt(*rargs, rcfg.n_steps, rseg, 1.5)[-1]
        dck = cuda_kernel.dopri_ckpt(*args, seg, ctl, **kw)[-1]
    bkw = dict(kw)
    del bkw["obj"]
    calls = {
        "rk4_fwd": no_grad(lambda: cuda_kernel.rk4_fwd(*rargs, rcfg.n_steps,
                                                       1.5)),
        "rk4_ckpt": no_grad(lambda: cuda_kernel.rk4_ckpt(
            *rargs, rcfg.n_steps, rseg, 1.5)),
        "rk4_bwd": no_grad(lambda: cuda_kernel.rk4_bwd(
            rscal, rck, r0.E, g, g, rcfg.n_steps, rseg, 1.5)),
        "dopri_fwd": no_grad(lambda: cuda_kernel.dopri_fwd(
            *dopri_args(env, dcfg_f, s0)[0], cuda_kernel.controller(dcfg_f),
            **kw)),
        "dopri_ckpt": no_grad(lambda: cuda_kernel.dopri_ckpt(
            *args, seg, ctl, **kw)),
        "dopri_bwd": no_grad(lambda: cuda_kernel.dopri_bwd(
            args[0], dck, s0.E, g, g, dcfg_g.n_steps, seg, ctl, **bkw)),
    }
    rops, rbytes, (steps, _, _), _ = rk4_bound(renv, rcfg, r0)
    dops, dbytes, (live, _, _), _ = dopri_bound(env, dcfg_f, dcfg_g, s0)
    plain = {"rk4": plain_kernel_ms(renv, r0, rcfg),
             "dopri": plain_kernel_ms(env, s0, dcfg_g)}
    plain["dopri"]["fwd"] = plain_kernel_ms(env, s0, dcfg_f)["fwd"]
    for name, fn in calls.items():
        method, kind = name.split("_")
        ops, nbytes = (rops, rbytes) if method == "rk4" else (dops, dbytes)
        out[name] = dict(ms=timed(fn), device_ms=device_ms(fn),
                         plain_ms=plain[method][kind],
                         max_abs_err=errs[name],
                         **bound(ops[kind], nbytes[kind]))
        readings[name]["timelike"] = out[name]
        log(f"# phase 30: {name} on the timelike fan: call "
            f"{out[name]['ms']:.3f} ms, device {out[name]['device_ms']:.3f} "
            f"ms, bound {out[name]['bound_ms']:.4f} ms by "
            f"{out[name]['bound_by']}, plain {out[name]['plain_ms']:.3f} ms "
            f"[{name_limit}]")
    log(f"# phase 30: {PARTICLES} particles, {steps} ray-steps of RK4 "
        f"({steps / PARTICLES:.2f} per particle), {sum(live)} ray-trips of "
        f"Dormand-Prince (the slowest particle {len(live)} of "
        f"{dcfg_f.n_steps} trips); rays aligned a step apart {aligned}")
    log(f"# phase 30: done in {time.perf_counter() - t_phase:.1f} s")


def compare_adaptive_particles(env, s0, a, b, max_step, what):
    """dopri_fwd's state ``a`` of massive particles from ``s0`` against the
    plain trip loop's ``b``: statuses on >= DOPRI_AGREE, lam within
    max_step; the particles that neither fall in nor start inside, away
    from their separatrix, and took the same trips (lam within SAME_TRIP)
    to the state tolerances; all in flight
    by what their paths conserve: x cross p within TOL_L of max(1, |L|),
    Hh within H_DRIFT of -1/2; every output finite.  Returns the largest
    error of the same-trip particles."""
    for s in (a, b):
        if not all(bool(torch.isfinite(t).all()) for t in (s.x, s.p, s.lam)):
            raise AssertionError(f"{what}: a non-finite output")
    agree = a.status == b.status
    share = float(agree.float().mean())
    dlam = (a.lam - b.lam).abs()
    fly = agree & (b.status != states.CAPTURED) & (
        b.status != states.INSIDE_HORIZON)
    same = fly & (dlam <= SAME_TRIP) & ~near_separatrix(env, s0)
    dx = masked_max((a.x - b.x).abs().amax(-1), same)
    dp = masked_max(((a.p - b.p).abs() / b.p.norm(dim=-1, keepdim=True)
                     .clamp_min(1.0)).amax(-1), same)
    La = torch.linalg.cross(a.x, a.p, dim=-1)
    Lb = torch.linalg.cross(b.x, b.p, dim=-1)
    dL = masked_max((La - Lb).abs().amax(-1)
                    / Lb.norm(dim=-1).clamp_min(1.0), fly)
    drift = max(masked_max((hamiltonian(s.x, s.p, s.E, env.mass) + 0.5)
                           .abs(), fly) for s in (a, b))
    hist = torch.bincount(b.status.long(), minlength=8).tolist()
    log(f"# particles [{what}, Dormand-Prince] statuses equal on "
        f"{share:.6f}; max|dlam| {masked_max(dlam, agree):.3e} (limit "
        f"{max_step:g}); {int(same.sum())} of {int(fly.sum())} in flight "
        f"on the same trips: max|dx| {dx:.3e} max|dp| {dp:.3e}; all in "
        f"flight: |dL| {dL:.3e}, |Hh + 1/2| {drift:.3e}; statuses {hist}")
    if not (share >= DOPRI_AGREE and masked_max(dlam, agree) <= max_step
            + 1e-3 and dx <= TOL_X and dp <= TOL_P and dL <= TOL_L
            and drift <= H_DRIFT and int(same.sum()) > int(fly.sum()) // 3):
        raise AssertionError(f"{what}: outside the Dormand-Prince limits")
    return max(dx, dp)



# =============================================================================
# Polarization and the Gen-1 hybrid: metrics, the Kerr transport ODE, the
# Stokes frame and the hybrid renderer through rk4_fwd.
# =============================================================================
def k1_frame(tag, fenv, icfg, s0, err, readings, name_limit):
    """rk4_fwd's readings on a frame of phases 32-33, under
    readings[variant][tag]: the call and device ms of one launch on the
    flat initial state ``s0``, its bound by phase 19's rule (rk4_bound:
    the frame's replayed ray-steps times the operations per ray-step
    counted on the plain step, and the state's bytes once), the plain
    loop's ms, and ``err``, the largest state error against it."""
    name = cuda_kernel.variant("rk4_fwd", fenv.spin is not None,
                               fenv.disk is not None
                               or fenv.spheres is not None)
    scal = cuda_kernel._scalars(fenv, icfg, s0.x.device)
    kw = event_kw(fenv, s0)
    call = no_grad(lambda: cuda_kernel.rk4_fwd(
        scal, s0.x, s0.p, s0.E, s0.lam, s0.status, icfg.n_steps,
        float(icfg.dt_power), **kw))
    ops, nbytes, (steps, _, _), _ = rk4_bound(fenv, icfg, s0)
    r = dict(ms=timed(call), device_ms=device_ms(call),
             plain_ms=once_ms(no_grad(lambda: cuda_kernel.integrate_plain(
                 fenv, s0, icfg))),
             max_abs_err=err, rays=s0.E.numel(), ray_steps=steps,
             **bound(ops["fwd"], nbytes["fwd"]))
    readings[name][tag] = r
    log(f"# {tag}: {name} on {r['rays']} rays ({steps} ray-steps): call "
        f"{r['ms']:.3f} ms, device {r['device_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
        f"{r['plain_ms']:.3f} ms [{name_limit}]")
    return r


def wrapped(a, b):
    """a - b wrapped into [-pi, pi)."""
    return torch.remainder(a - b + np.pi, 2 * np.pi) - np.pi


def compare_maps(m, mp, hold, what, tol):
    """Polarization map ``m`` against ``mp``: the NaN patterns equal but
    for at most MAX_EDGE rays at the escape edge, and the wrapped angle
    difference within ``tol`` on the rays of ``hold`` finite in both.
    Returns (the largest difference held, the largest elsewhere)."""
    nan_flip = int((torch.isnan(m) != torch.isnan(mp)).sum())
    both = ~torch.isnan(m) & ~torch.isnan(mp)
    d = wrapped(m, mp).abs()
    held = masked_max(d, both & hold)
    other = masked_max(d, both & ~hold)
    log(f"# map [{what}] {int(both.sum())} angles in both, {nan_flip} NaN "
        f"flips (at most {MAX_EDGE}); wrapped |d| {held:.3e} on "
        f"{int((both & hold).sum())} rays held (limit {tol:g}), "
        f"{other:.3e} on the {int((both & ~hold).sum())} others")
    if not (nan_flip <= MAX_EDGE and held <= tol):
        raise AssertionError(f"{what}: map outside its limits")
    return held, other


def kerr_pol_frame(dev, size=None):
    """bench.py bench_stokes's Kerr polarization row (:825-838): the sky
    around a hole of a = 0.45, the events camera (0, 0, 25) tilted by 0.25
    rad, fov 0.8, the flagship schedule, lam_max 200, at ``size``^2
    (POL_KERR)."""
    size = size or POL_KERR
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, spin=0.45, device=dev),
                    background=torch.as_tensor(make_sky(),
                                               dtype=torch.float32,
                                               device=dev))
    cfg = dataclasses.replace(flagship_cfg(), width=size, height=size,
                              lam_max=200.0)
    return scene, events_cam(dev), cfg


def on_cpu(obj):
    """A scene or camera dataclass tree with its tensors on the CPU."""
    if obj is None or isinstance(obj, torch.Tensor):
        return None if obj is None else obj.cpu()
    return dataclasses.replace(obj, **{
        f.name: on_cpu(getattr(obj, f.name))
        for f in dataclasses.fields(obj)})


def phase_polarization_kerr(dev, name_limit, readings):
    """The metrics and the Kerr polarization map: ks_directional_christoffel
    against the Metric.christoffel contraction at FAN points (a = 0.45, 0,
    -0.3); bench_stokes's POL_KERR^2 Kerr map through the transport ODE,
    no kernel launched, its invariants on the finished rays, and a seeded
    POL_SUBSET of its rays against the same function on the CPU; times."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    x4 = f(np.c_[np.zeros(FAN), rng.uniform(-10, 10, (FAN, 3))])
    k4, v4 = f(rng.normal(size=(FAN, 4))), f(rng.normal(size=(FAN, 4)))
    worst = 0.0
    for a in (0.45, 0.0, -0.3):
        gam = kerr_ks_metric(0.5, a).christoffel(x4)
        con = ks_directional_christoffel(0.5, a)
        for v in (k4, v4):
            want = torch.sum(gam * k4[:, None, :, None]
                             * v[:, None, None, :], dim=(-2, -1))
            err = ((con(x4, k4, v) - want).abs().amax(-1)
                   / want.abs().amax(-1).clamp_min(1e-3))
            worst = max(worst, float(err.max()))
    del gam
    log(f"# phase 31: ks_directional_christoffel against the AD Christoffel "
        f"contraction at {FAN} points, a = 0.45, 0, -0.3: {worst:.3e} of "
        f"each point's largest entry (limit {TOL_CHRISTOFFEL:g})")
    check(worst <= TOL_CHRISTOFFEL,
          "ks_directional_christoffel differs from the AD contraction")

    scene, cam, cfg = kerr_pol_frame(dev)
    reset_counts()
    with torch.no_grad():
        m = P.polarization_map(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches == {}, f"the Kerr polarization map launched {launches}")
    if m.shape != (POL_KERR, POL_KERR):
        raise AssertionError(f"Kerr map of shape {tuple(m.shape)}")
    # the transport ODE as polarization_rays runs it, for its invariants
    ys, xs = pixel_grid(POL_KERR, POL_KERR, device=dev)
    o, d = generate_rays(cam, POL_KERR, POL_KERR, ys, xs)
    x3, d3 = (o - scene.bh.loc).reshape(-1, 3), d.reshape(-1, 3)
    n = plane_normal(x3, d3)
    it = cfg.integrator
    with torch.no_grad():
        f_obs, d1, x1, diag = transport_polarization_ode(
            kerr_ks_metric(scene.bh.mass, scene.bh.spin), x3, d3,
            _unit(_cross(d3, n)), n_steps=it.n_steps, dt=it.dt,
            r_stop=70.0, dt_boost=it.dt_boost, r_ref=it.dt_boost_r_ref)
    # the finished rays are those that escaped, the map's angles; they are
    # held away from b_c, where the schedule's long steps meet the photon
    # orbits (those rays' drift, and that of the rays stopped at the
    # capture radius by the horizon, are readings)
    done = x1.norm(dim=-1) >= 0.99 * 70.0
    kenv, ks0 = flagship_rays(scene, cam, cfg, dev, size=POL_KERR)
    near = near_b_c(kenv, ks0).reshape(-1)
    fk = masked_max(diag["fk_drift"], done & ~near)
    nd = masked_max(diag["norm_drift"], done & ~near)
    fk_near = masked_max(diag["fk_drift"], done & near)
    fk_in = masked_max(diag["fk_drift"], ~done)
    ang = torch.atan2(torch.sum(f_obs * n, -1),
                      torch.sum(f_obs * _unit(_cross(d1, n)), -1))
    ang = torch.where(done, ang, torch.nan)
    flat_m = m.reshape(-1)
    same = torch.equal(torch.isnan(ang), torch.isnan(flat_m)) and (
        masked_max((ang - flat_m).abs(), ~torch.isnan(ang)) == 0.0)
    log(f"# phase 31: Kerr map {POL_KERR}x{POL_KERR}: no kernel launched; "
        f"{int(done.sum())} of {done.numel()} rays escaped, "
        f"{int(diag['unfinished'].sum())} unfinished; on the "
        f"{int((done & ~near).sum())} escaped away from b_c |f.k| <= "
        f"{fk:.3e} (limit {FK_DRIFT:g}), |g(f,f) - g0| <= {nd:.3e} (limit "
        f"{NORM_DRIFT:g}); |f.k| <= {fk_near:.3e} on the "
        f"{int((done & near).sum())} escaped near b_c, {fk_in:.3e} on the "
        "others; the ODE run alone gives the map "
        + ("bit for bit" if same else "DIFFERENTLY"))
    check(fk <= FK_DRIFT and nd <= NORM_DRIFT,
          "the Kerr transport broke its invariants")
    check(same, "polarization_map differs from its transport ODE")

    # a seeded subset of the rays through the same function on the CPU
    pick = torch.as_tensor(rng.choice(POL_KERR * POL_KERR, POL_SUBSET,
                                      replace=False))
    sub_y, sub_x = pick // POL_KERR, pick % POL_KERR
    m_cpu, cpu_ms = once(no_grad(lambda: P.polarization_rays(
        on_cpu(scene), on_cpu(cam), cfg, sub_y, sub_x)))
    held, other = compare_maps(m.cpu()[sub_y, sub_x], m_cpu,
                               ~near.cpu()[pick],
                               f"Kerr map, {POL_SUBSET} rays card vs CPU",
                               TOL_POL)
    map_ms = timed(no_grad(lambda: P.polarization_map(scene, cam, cfg)),
                   runs=3)
    readings["polarization"] = dict(
        kerr_map_ms=map_ms, kerr_subset_cpu_ms=cpu_ms, kerr_err=held,
        kerr_err_near_b_c=other, christoffel_err=worst, fk_drift=fk,
        norm_drift=nd, fk_drift_near_b_c=fk_near)
    log(f"# phase 31: Kerr map {POL_KERR}x{POL_KERR} (the transport ODE, "
        f"{it.n_steps} RK4 steps of PyTorch operations): median {map_ms:.3f}"
        f" ms; {POL_SUBSET} of its rays on the CPU {cpu_ms:.3f} ms "
        f"[{name_limit}]")
    log(f"# phase 31: done in {time.perf_counter() - t_phase:.1f} s")


def stokes_scene(dev):
    """bench.py bench_stokes's scene (:772-786): the flagship sky and the
    events scene's disk (r 2-6, its 64x256 texture) with pol_frac 0.7."""
    ev = events_scene(dev)
    return P.Scene(bh=ev.bh, background=ev.background,
                   disk=dataclasses.replace(ev.disk, pol_frac=torch.tensor(
                       0.7, device=dev)))


def phase_stokes(dev, name_limit, readings):
    """bench_stokes's SIZE^2 frame through render_stokes: rk4_fwd's event
    variant once and nothing else, rgb against the plain render, each
    ray's final state as phase 11 holds them, Q and U on the rays whose
    status agrees within TOL_STOKES; the flagship sky's SIZE^2
    Schwarzschild polarization map through rk4_fwd against the plain map;
    times."""
    t_phase = time.perf_counter()
    scene, cam = stokes_scene(dev), events_cam(dev)
    cfg, plain = flagship_cfg(), flagship_cfg("torch")
    reset_counts()
    with torch.no_grad():
        rgb, Q, U = P.render_stokes(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    count_path(readings, "Stokes frame", launches)
    check(launches == only(rk4_fwd_events=1),
          f"the Stokes frame launched {launches}, expected rk4_fwd_events "
          "once")
    if rgb.shape != (SIZE, SIZE, 3) or Q.shape != (SIZE, SIZE) or not (
            bool(torch.isfinite(rgb).all() & torch.isfinite(Q).all()
                 & torch.isfinite(U).all())):
        raise AssertionError("the Stokes frame is not finite of its shape")
    (rgb_p, Q_p, U_p), plain_ms = once(no_grad(
        lambda: P.render_stokes(scene, cam, plain)))
    image_rule(rgb, rgb_p, f"{SIZE}x{SIZE} Stokes rgb, kernel vs plain",
               FLAGSHIP_MEAN, FLAGSHIP_FRAC)
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    icfg = cfg.integrator
    with torch.no_grad():
        s = cuda_kernel.integrate_cuda(fenv, s0, icfg)
        sp = cuda_kernel.integrate_plain(fenv, s0, icfg)
    near = near_b_c(fenv, s0) | ulp_sensitive(fenv, icfg, s0, sp)
    e, _, n_edge = compare_events(fenv, icfg, flat_state(s0), flat_state(s),
                                  flat_state(sp), f"{SIZE}x{SIZE} Stokes",
                                  near.reshape(-1))
    same = s.status == sp.status
    dq = torch.maximum((Q - Q_p).abs(), (U - U_p).abs())
    dq_max = masked_max(dq, same)
    pol = int((torch.hypot(Q_p, U_p) > 1e-4).sum())
    log(f"# phase 32: Stokes Q/U on the {int(same.sum())} rays whose status "
        f"agrees: max |d| {dq_max:.3e} (limit {TOL_STOKES:g}); {pol} "
        f"polarized pixels; {n_edge} edge rays left out")
    check(dq_max <= TOL_STOKES and pol > SIZE,
          "the Stokes Q/U differ from the plain render's")
    k1_frame("stokes", fenv, icfg, flat_state(s0), e, readings, name_limit)
    stokes_ms = timed(no_grad(lambda: P.render_stokes(scene, cam, cfg)),
                      runs=5)

    # the Schwarzschild polarization map of the flagship frame
    sky = P.Scene(bh=scene.bh, background=scene.background)
    fcam = P.Camera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8),
                         device=dev)
    reset_counts()
    with torch.no_grad():
        m = P.polarization_map(sky, fcam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    count_path(readings, "polarization map", launches)
    check(launches == only(rk4_fwd=1),
          f"the Schwarzschild map launched {launches}, expected rk4_fwd once")
    mp, map_plain_ms = once(no_grad(lambda: P.polarization_map(sky, fcam,
                                                              plain)))
    menv, ms0 = flagship_rays(sky, fcam, cfg, dev)
    held, other = compare_maps(m, mp, ~near_b_c(menv, ms0),
                               f"{SIZE}x{SIZE} Schwarzschild map, kernel vs "
                               "plain", TOL_DIR)
    map_ms = timed(no_grad(lambda: P.polarization_map(sky, fcam, cfg)),
                   runs=5)
    readings.setdefault("polarization", {}).update(
        stokes_ms=stokes_ms, stokes_plain_ms=plain_ms, stokes_err=dq_max,
        schw_map_ms=map_ms, schw_map_plain_ms=map_plain_ms,
        schw_map_err=held, schw_map_err_near_b_c=other)
    log(f"# phase 32: render_stokes {SIZE}x{SIZE}: median {stokes_ms:.3f} ms"
        f" (plain {plain_ms:.3f}); Schwarzschild polarization_map "
        f"{SIZE}x{SIZE}: median {map_ms:.3f} ms (plain {map_plain_ms:.3f}) "
        f"[{name_limit}]")
    log(f"# phase 32: done in {time.perf_counter() - t_phase:.1f} s")


def bright_sky():
    """bench.py _surrogate_image_compare's sky (:940-947): bright, so the
    shadow's mask sees no dark sky texel."""
    v, u = np.meshgrid(np.arange(128), np.arange(256), indexing="ij")
    return np.stack([
        0.65 + 0.35 * np.sin(2 * np.pi * u / 256) * np.sin(np.pi * v / 128),
        0.5 + 0.3 * np.cos(6 * np.pi * u / 256),
        0.6 + 0.4 * ((u // 16 + v // 16) % 2)], -1).astype(np.float32)


def hybrid_kerr_frame(dev, spin=0.45):
    """bench.py _surrogate_image_compare's Gen-1 frame (:925-948): a hole
    of a = ``spin`` before the bright sky, camera (0, 0, 30), fov 0.35,
    HYBRID^2, 512 RK4 steps of dt 0.05 grown up to 4x, lam_max 200, the
    influence sphere at 20 without debug colours."""
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, spin=spin, device=dev),
                    background=torch.as_tensor(bright_sky(), device=dev))
    cam = P.Camera.make(position=(0.0, 0.0, 30.0), fov=(0.35, 0.35),
                        device=dev)
    cfg = P.RenderConfig(width=HYBRID, height=HYBRID, lam_max=200.0,
                         integrator=P.IntegratorConfig(n_steps=512, dt=0.05,
                                                       dt_boost=4.0))
    return scene, cam, cfg, P.LimitedConfig(approx=False,
                                            debug_colors=False)


def hybrid_events_frame(dev):
    """A Schwarzschild Gen-1 frame with a disk, moons and debug colours:
    the events scene's sky and disk, an emissive moon behind the hole at
    (0, 0, -20) and a red Lambertian moon at (-10, 4, -8), both outside the
    influence sphere of radius 10, lit by a lamp at (30, 0, 40); the
    camera of tests/test_limited.py's disk frame, (0, 12, 38) tilted by
    -0.3 rad, fov 0.6; the reference's 400 steps of 0.1, and an affine
    budget of 24, a little over the influence sphere's diameter, so the
    rays that circle the photon orbits end on it: RED debug pixels."""
    ev = events_scene(dev)
    moons = P.Spheres.make(
        center=[[0.0, 0.0, -20.0], [-10.0, 4.0, -8.0]], radius=[1.5, 2.0],
        texture=np.tile(np.float32([0.2, 1.0, 0.2]), (2, 8, 8, 1)),
        emission=[1.0, 0.0], albedo=[[1.0, 1.0, 1.0], [1.0, 0.1, 0.1]],
        device=dev)
    scene = P.Scene(bh=ev.bh, background=ev.background, disk=ev.disk,
                    spheres=moons,
                    lights=P.Lights.make([[30.0, 0.0, 40.0]], device=dev))
    cam = P.Camera.make(position=(0.0, 12.0, 38.0), euler=(-0.3, 0.0, 0.0),
                        fov=(0.6, 0.6), device=dev)
    cfg = P.RenderConfig(width=HYBRID, height=HYBRID, lam_max=24.0,
                         integrator=P.IntegratorConfig(n_steps=400, dt=0.1))
    return scene, cam, cfg, P.LimitedConfig(r_influence=10.0)


def hybrid_state(scene, cam, cfg, lcfg, dev):
    """The environment and flat initial state render_limited integrates
    for ``scene`` from ``cam`` (render/limited.py geodesic_state)."""
    ys, xs = pixel_grid(cfg.width, cfg.height, device=dev)
    o, d = generate_rays(cam, cfg.width, cfg.height, ys, xs)
    t1, _, enters = limited._flat_cast(scene, lcfg, o, d)
    x1 = o + d * torch.where(torch.isfinite(t1), t1, 0.0)[..., None]
    env, s0 = limited.geodesic_state(scene, cfg, lcfg,
                                     (x1 - scene.bh.loc) * (1.0 - 1e-4), d,
                                     enters)
    return env, flat_state(s0)


def preset_kept(env, cfg, s0, what):
    """rk4_fwd on ``s0``: its pre-set (not ACTIVE) rays must come back
    equal to their input bit for bit.  Returns (the kernel state, the
    pre-set ESCAPED and INSIDE_HORIZON counts)."""
    with torch.no_grad():
        sk = cuda_kernel.integrate_cuda(env, s0, cfg)
    pre = s0.status != states.ACTIVE
    same = all(torch.equal(getattr(sk, k)[pre], getattr(s0, k)[pre])
               for k in ("x", "p", "E", "lam", "status", "hit_obj"))
    n_esc = int((s0.status == states.ESCAPED).sum())
    n_in = int((s0.status == states.INSIDE_HORIZON).sum())
    log(f"# phase 33: {what}: {n_esc} pre-set ESCAPED and {n_in} "
        f"INSIDE_HORIZON rays come back from rk4_fwd "
        + ("equal bit for bit" if same else "CHANGED"))
    check(same, f"{what}: rk4_fwd changed pre-set rays")
    return sk, n_esc, n_in


def compare_hybrid(env, cfg, s0, a, b, what, near):
    """A hybrid frame's rays, kernel state ``a`` against plain state ``b``:
    a ray whose status or hit id differs must be in ``near`` or touch an
    event's edge, at most MAX_EDGE of them; the other rays away from
    ``near`` are held to the state tolerances (compare_states).  The rays
    in ``near`` are held by their status alone: the frames' step budgets
    leave rays circling the photon orbits ACTIVE at the end, on paths two
    correct float32 loops part on (their largest |d lam| is a reading).
    Returns (error, status flips)."""
    flip = (a.status != b.status) | (a.hit_obj != b.hit_obj)
    n = int(flip.sum())
    if n > MAX_EDGE:
        raise AssertionError(f"{what}: {n} statuses or hit ids differ")
    far = flip & ~near
    if bool(far.any()) and not float(event_margin(
            env, cfg, rays(s0, far)).max()) <= EVENT_EPS:
        raise AssertionError(f"{what}: a ray away from b_c and from any "
                             "event's edge changed its status")
    keep = ~flip & ~near
    err, _ = compare_states(env, cfg, rays(a, keep), rays(b, keep),
                            f"{what}, away from b_c")
    band = ~flip & near
    log(f"# parity [{what}, near b_c] n={int(band.sum())} statuses equal, "
        f"{n} flips left out; max|dlam|="
        f"{masked_max((a.lam - b.lam).abs(), band):.3e} (a reading)")
    return err, n


DEBUG_COLORS = {"RED": (1.0, 0.0, 0.0), "BLUE": (0.0, 0.0, 1.0),
                "GREEN": (0.0, 1.0, 0.0)}


def hybrid_pixels(img, ref, what):
    """Image mean |d| against the plain render, the shadow (max channel <
    1e-3) pixel counts within SHADOW_PX, and the pixels of each debug
    colour equal but for MAX_EDGE.  Returns the debug colours' counts."""
    image_rule(img, ref, what, HYBRID_MEAN, HYBRID_FRAC)
    black = int((img[..., :3].amax(-1) < 1e-3).sum())
    black_p = int((ref[..., :3].amax(-1) < 1e-3).sum())
    counts, flips = {}, 0
    for name, c in DEBUG_COLORS.items():
        c = img.new_tensor(c)
        mk, mp = ((x[..., :3] == c).all(-1) for x in (img, ref))
        counts[name] = int(mp.sum())
        flips += int((mk != mp).sum())
    log(f"# phase 33: {what}: shadow {black} vs {black_p} pixels (limit "
        f"{SHADOW_PX}); debug colours {counts}, {flips} pixels differ "
        f"(at most {MAX_EDGE})")
    check(abs(black - black_p) <= SHADOW_PX and flips <= MAX_EDGE,
          f"{what}: shadow or debug colours differ from the plain render's")
    return counts


def phase_hybrid(dev, name_limit, readings):
    """The Gen-1 hybrid (render_limited) at HYBRID^2: bench.py's Kerr frame
    through rk4_fwd_kerr and a Schwarzschild frame with a disk, a lit moon
    and debug colours through rk4_fwd_events, each against the plain
    render and its rays against the plain loop; the pre-set ESCAPED and
    INSIDE_HORIZON rays through rk4_fwd bit for bit; SurrogateTable.build
    through rk4_fwd against the plain build on the CPU, and the approx
    frame from its table; times."""
    t_phase = time.perf_counter()
    out = {}
    for tag, frame, kernel in (
            ("hybrid Kerr frame", hybrid_kerr_frame, "rk4_fwd_kerr"),
            ("hybrid frame", hybrid_events_frame, "rk4_fwd_events")):
        scene, cam, cfg, lcfg = frame(dev)
        plain = dataclasses.replace(cfg, integrator=dataclasses.replace(
            cfg.integrator, backend="torch"))
        reset_counts()
        with torch.no_grad():
            img = P.render_limited(scene, cam, cfg, lcfg)
        torch.cuda.synchronize()
        launches = read_counts()
        count_path(readings, tag, launches)
        check(launches == only(**{kernel: 1}),
              f"{tag} launched {launches}, expected {kernel} once")
        if img.shape != (HYBRID, HYBRID, 4) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"{tag} is not a finite image")
        ref, plain_ms = once(no_grad(lambda: P.render_limited(
            scene, cam, plain, lcfg)))
        colours = hybrid_pixels(img, ref, f"{tag} {HYBRID}x{HYBRID}, kernel "
                                "vs plain")
        env, s0 = hybrid_state(scene, cam, cfg, lcfg, dev)
        sk, n_esc, _ = preset_kept(env, cfg.integrator, s0, tag)
        with torch.no_grad():
            sp = cuda_kernel.integrate_plain(env, s0, cfg.integrator)
        near = (near_b_c(env, s0)
                | ulp_sensitive(env, cfg.integrator, s0, sp))
        err, n_flip = compare_hybrid(env, cfg.integrator, s0, sk, sp,
                                     f"{tag}, rays", near)
        # an influence sphere inside the capture radius: every entering ray
        # starts INSIDE_HORIZON, every other ESCAPED
        tenv, ts0 = hybrid_state(scene, cam, cfg, dataclasses.replace(
            lcfg, r_influence=0.5), dev)
        _, _, n_in = preset_kept(tenv, cfg.integrator, ts0,
                                 f"{tag}, influence sphere 0.5")
        check(n_in > 0, f"{tag}: no ray started INSIDE_HORIZON")
        k1_frame(tag, env, cfg.integrator, s0, err, readings, name_limit)
        ms = timed(no_grad(lambda: P.render_limited(scene, cam, cfg, lcfg)),
                   runs=5)
        out[tag] = dict(ms=ms, plain_ms=plain_ms, preset_escaped=n_esc,
                        status_flips=n_flip, **colours)
        log(f"# phase 33: {tag} {HYBRID}x{HYBRID}: median {ms:.3f} ms "
            f"(plain {plain_ms:.3f}) [{name_limit}]")

    # the approx path: SurrogateTable.build through rk4_fwd, then a frame
    lcfg = P.LimitedConfig(approx=True, debug_colors=False)
    reset_counts()
    table, build_ms = once(no_grad(lambda: P.SurrogateTable.build(
        mass=0.5, r_influence=lcfg.r_influence,
        exit_tolerance=lcfg.exit_tolerance, device=dev)))
    launches = read_counts()
    count_path(readings, "surrogate table", launches)
    check(launches == only(rk4_fwd=1),
          f"SurrogateTable.build launched {launches}, expected rk4_fwd once")
    tp, build_plain_ms = once(no_grad(lambda: P.SurrogateTable.build(
        mass=0.5, r_influence=lcfg.r_influence,
        exit_tolerance=lcfg.exit_tolerance, device="cpu")))
    cap_equal = torch.equal(table.captured.cpu(), tp.captured)
    calm = ~tp.captured & ((tp.b - 1.5 * np.sqrt(3.0)).abs() > TABLE_BAND)
    chord = (table.end_dir.cpu() - tp.end_dir).norm(dim=-1).double()
    dang = 2.0 * torch.asin((0.5 * chord).clamp(max=1.0))
    dloc = (table.end_loc.cpu() - tp.end_loc).abs().amax(-1)
    d_calm = masked_max(dang, calm)
    d_band = masked_max(dang, ~tp.captured & ~calm)
    log(f"# phase 33: SurrogateTable.build (512 rays, 4000 steps) through "
        f"rk4_fwd against the plain build on the CPU: captured "
        + ("equal" if cap_equal else "DIFFERS")
        + f"; exit directions within {d_calm:.3e} rad on the "
        f"{int(calm.sum())} escaping rays {TABLE_BAND:g} or more from b_c "
        f"(limit {TOL_DIR:g}; {d_band:.3e} nearer), exit points within "
        f"{masked_max(dloc, calm):.3e}")
    check(cap_equal and d_calm <= TOL_DIR,
          "SurrogateTable.build differs from the plain build")
    R = lcfg.r_influence
    tenv = GeodesicEnv(mass=torch.tensor(0.5, device=dev),
                       r_capture=torch.tensor(1.0, device=dev),
                       r_escape=torch.tensor(R * 1.1, device=dev),
                       lam_max=torch.tensor(200.0, device=dev))
    bs = torch.linspace(0.0, R * 0.999, 512, device=dev)
    x0 = torch.stack([-torch.sqrt((R * R - bs * bs).clamp_min(0.0)), bs,
                      torch.zeros_like(bs)], -1) * (1.0 - 1e-4)
    ts0 = states.init_state(x0, *null_init(x0, torch.tensor(
        [1.0, 0.0, 0.0], device=dev).expand(512, 3), tenv.mass))
    k1_frame("surrogate table", tenv, P.IntegratorConfig(
        n_steps=4000, dt=0.05, dt_boost=1.0), ts0, d_calm, readings,
        name_limit)

    scene, cam, cfg, _ = hybrid_kerr_frame(dev, spin=None)
    with torch.no_grad():
        exact = P.render_limited(scene, cam, cfg, dataclasses.replace(
            lcfg, approx=False))
        reset_counts()
        approx = P.render_limited(scene, cam, cfg, lcfg, table=table)
        launches = read_counts()
    sh_e = exact[..., :3].amax(-1) < 1e-3
    sh_a = approx[..., :3].amax(-1) < 1e-3
    sh_off = float((sh_e != sh_a).float().mean())
    med = float((exact[..., :3] - approx[..., :3]).abs().median())
    log(f"# phase 33: approx frame {HYBRID}x{HYBRID} from that table "
        f"(launches {launches}): shadow pixels differ from the exact "
        f"frame's on {sh_off:.4f} (limit 0.02), median |d| {med:.3e} "
        "(limit 0.02)")
    check(launches == {} and bool(torch.isfinite(approx).all())
          and sh_off < 0.02 and med < 0.02,
          "the approx frame differs from the exact frame")
    approx_ms = timed(no_grad(lambda: P.render_limited(
        scene, cam, cfg, lcfg, table=table)), runs=5)
    out["surrogate table"] = dict(build_ms=build_ms,
                                  build_plain_cpu_ms=build_plain_ms,
                                  approx_frame_ms=approx_ms)
    readings["hybrid"] = out
    log(f"# phase 33: SurrogateTable.build {build_ms:.3f} ms (plain on the "
        f"CPU {build_plain_ms:.3f}); approx frame {HYBRID}x{HYBRID} median "
        f"{approx_ms:.3f} ms [{name_limit}]")
    log(f"# phase 33: done in {time.perf_counter() - t_phase:.1f} s")


# =============================================================================
# Phases 34-39: the full-size goldens, the learned surrogate, the sharded
# renders, the Trainer and its checkpoints.
# =============================================================================
def baseline_sky(dev):
    """tests/test_golden_baseline.py's sky: 64x128, 8-pixel checks."""
    return torch.as_tensor(make_sky(64, 128, check=8), dtype=torch.float32,
                           device=dev)


def baseline_integrator():
    """The goldens' RK4 schedule (test_golden_baseline.py:108-111)."""
    return P.IntegratorConfig(n_steps=400, dt=0.06, dt_boost=48.0,
                              dt_boost_r_ref=1.6, dt_power=1.5)


def golden_frames(dev):
    """(name, scene, camera, config, the K1 variant it launches, its
    oracles) of test_golden_1024_disk_and_four_moons (:94-123) and
    test_golden_512_kerr_a09 (:154-182), built from the same arrays."""
    moons = np.zeros((4, 8, 8, 3), np.float32)
    for k in range(4):
        moons[k, ..., k % 3] = 1.0
    disk_scene = P.Scene(
        bh=P.BlackHole.make(mass=0.5, device=dev), background=baseline_sky(
            dev),
        disk=P.Disk.make(r_in=2.0, r_out=6.0, device=dev, texture=np.tile(
            np.float32([1.0, 0.6, 0.2]), (8, 32, 1))),
        spheres=P.Spheres.make(
            center=[[6.0, 2.0, 6.0], [-5.0, -2.0, -8.0], [0.0, 4.0, -10.0],
                    [8.0, -1.0, -3.0]],
            radius=[0.8, 0.8, 0.6, 0.5], texture=moons, device=dev))

    def disk_oracles(img):
        upper = img[300:450, 400:624, :3].reshape(-1, 3)
        orange = (upper[:, 0] > 0.3) & (upper[:, 0] > upper[:, 2] * 1.5)
        share = float(orange.float().mean())
        return {"orange share above the shadow": share}, share > 0.05

    def kerr_oracles(img):
        dark = img[..., :3].amax(-1) < 0.02
        top, bottom = int(dark[:256].sum()), int(dark[256:].sum())
        asym = abs(top - bottom) / max(top + bottom, 1)
        return ({"dark pixels": top + bottom, "top/bottom asymmetry": asym},
                top + bottom > 1000 and asym > 0.05)

    yield ("disk_four_moons_1024", disk_scene,
           P.Camera.make(position=(0.0, 6.0, 19.0), euler=(-0.3, 0.0, 0.0),
                         fov=(0.9, 0.9), device=dev),
           P.RenderConfig(width=1024, height=1024, lam_max=120.0,
                          integrator=baseline_integrator()),
           "rk4_fwd_events", disk_oracles)
    yield ("kerr_a09_512",
           P.Scene(bh=P.BlackHole.make(mass=0.5, spin=0.45, device=dev),
                   background=baseline_sky(dev)),
           P.Camera.make(position=(20.0, 0.0, 0.0),
                         euler=(0.0, np.pi / 2, 0.0), fov=(0.9, 0.9),
                         device=dev),
           P.RenderConfig(width=512, height=512, lam_max=120.0,
                          integrator=baseline_integrator()),
           "rk4_fwd_kerr", kerr_oracles)


def golden_drift(name, img):
    """tests/test_golden_baseline.py _check_golden (:50-62): the image 4x
    mean-pooled and cast to float16 against the checked-in golden: (mean
    drift, share of cells moved by more than 0.05).  Never writes one."""
    ref = np.load(ROOT / "tests" / "golden" / f"{name}.npz")["img"].astype(
        np.float32)
    small = pool4(img.cpu().numpy()).astype(np.float16).astype(np.float32)
    diff = np.abs(small - ref)
    return float(diff.mean()), float((diff > 0.05).mean())


def phase_goldens(dev, readings):
    """The two full-size goldens only the JAX package was held to:
    BASELINE config 3 at 1024^2 (a disk and four moons, RK4 400 steps)
    through rk4_fwd_events and the a/M = 0.9 Kerr frame at 512^2, camera
    edge-on to the spin axis, through rk4_fwd_kerr, each one launch of
    render_image, held to the file's rule (mean drift < GOLDEN_DRIFT, <
    GOLDEN_MOVED of the cells moved by > 0.05) and its oracles."""
    for name, scene, cam, cfg, kernel, oracles in golden_frames(dev):
        reset_counts()
        with torch.no_grad():
            img = P.render_image(scene, cam, cfg)
        torch.cuda.synchronize()
        launches = read_counts()
        count_path(readings, f"golden {name}", launches)
        check(launches == only(**{kernel: 1}),
              f"golden {name} launched {launches}, expected {kernel} once")
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"golden {name}: the image is not finite")
        drift, moved = golden_drift(name, img)
        values, ok = oracles(img)
        log(f"# phase 34: golden [{name}, {kernel}] mean drift {drift:.3e} "
            f"(limit {GOLDEN_DRIFT:g})")
        log(f"# phase 34: golden [{name}, {kernel}] {moved:.3e} of the cells "
            f"moved by > 0.05 (limit {GOLDEN_MOVED:g})")
        for k, v in values.items():
            log(f"# phase 34: golden [{name}] oracle {k}: {v:.6g}")
        check(drift < GOLDEN_DRIFT and moved < GOLDEN_MOVED and ok,
              f"golden {name}: the rule or an oracle failed")
        readings.setdefault("goldens", {})[name] = dict(
            drift=drift, moved=moved, **values)


def generator(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def in_chunks(fn, *args, chunk=1 << 18):
    """``fn`` over ``args`` split along the first axis, the outputs
    concatenated: bounds the host memory of the CPU trace."""
    outs = [fn(*(a[i:i + chunk] for a in args))
            for i in range(0, args[0].shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def unprojected_exit(sur, entry, d):
    """The exit point ``NeuralSurrogate.trace`` projects onto the exit
    shell, in the canonical frame: (the chord's exit + the network's
    residual) R."""
    dn = d / d.norm(dim=-1, keepdim=True)
    entry_c, d_c, _, _ = canonicalize(entry, dn)
    out, _, _ = sur.raw(entry, dn)
    R = sur.r_influence
    return (_straight_exit(entry_c, d_c, R) + out[..., 3:6]) * R


def phase_surrogate_infer(dev, name_limit, readings):
    """A full-width (256 x 5) NeuralSurrogate from init_params on the
    card: its f32 trace of SUR_RAYS entries against the same model's on
    the CPU (directions within TOL_SUR, exit points within TOL_SUR of the
    exit radius where the point before its projection onto the shell
    lies R/2 or more from the centre; captures equal but MAX_EDGE), its
    bf16 trace by the JAX
    test's bars (directions within 0.1 of f32, captures agreeing on more
    than 95%, other bits), each precision's time, and the equivariance
    residual under a rotation about the spin axis and the reflection."""
    cfg = SurrogateConfig()
    sur = NeuralSurrogate(init_params(generator(dev, 0), cfg), mass=0.5,
                          spin=0.45, r_influence=cfg.r_influence)
    host = NeuralSurrogate([(w.cpu(), b.cpu()) for w, b in sur.params],
                           mass=0.5, spin=0.45, r_influence=cfg.r_influence)
    entry, d = sample_entries(generator(dev, 1), SUR_RAYS, cfg, 0.5)
    reset_counts()
    with torch.no_grad():
        loc, dir_, cap = sur.trace(entry, d)
        calm = (unprojected_exit(sur, entry, d).norm(dim=-1)
                >= 0.5 * sur.r_influence).cpu()
        hloc, hdir, hcap = in_chunks(host.trace, entry.cpu(), d.cpu())
    check(read_counts() == {}, "the surrogate's trace launched a kernel")
    r_exit = float(sur.r_exit)
    dl = (loc.cpu() - hloc).abs().amax(-1) / r_exit
    dloc, dloc_all = masked_max(dl, calm), float(dl.max())
    ddir = float((dir_.cpu() - hdir).abs().max())
    flips = int((cap.cpu() != hcap).sum())
    log(f"# phase 35: trace f32, card vs CPU, {SUR_RAYS} rays: max |d dir| "
        f"{ddir:.3e}; exit points max |d| / r_exit {dloc:.3e} on the "
        f"{int(calm.sum())} rays whose point before the shell projection "
        f"lies >= R/2 from the centre ({dloc_all:.3e} on all: the "
        f"projection divides by that distance) (limits {TOL_SUR:g}); "
        f"{flips} captures differ (at most {MAX_EDGE}); {int(cap.sum())} "
        "captured")
    check(ddir <= TOL_SUR and dloc <= TOL_SUR and flips <= MAX_EDGE,
          "the surrogate's f32 trace on the card differs from the CPU's")

    sur.precision = "bf16"
    with torch.no_grad():
        bloc, bdir, bcap = sur.trace(entry, d)
    b_dir = float((bdir - dir_).abs().max())
    agree = float((bcap == cap).float().mean())
    differs = not torch.equal(bloc, loc)
    log(f"# phase 35: trace bf16 against f32: max |d dir| {b_dir:.3e} "
        f"(limit 0.1), captures agree on {agree:.5f} (limit 0.95), bits "
        + ("differ" if differs else "IDENTICAL"))
    check(b_dir < 0.1 and agree > 0.95 and differs,
          "the bf16 trace is not f32's to bf16 rounding")

    times = {}
    for prec in ("f32", "bf16"):
        sur.precision = prec
        times[prec] = timed(no_grad(lambda: sur.trace(entry, d)), runs=5)
        log(f"# phase 35: trace {prec} {SUR_RAYS} rays: median "
            f"{times[prec]:.3f} ms, {SUR_RAYS / times[prec] * 1e3:.4e} "
            f"rays/s [{name_limit}]")
    sur.precision = "f32"

    # equivariance: a rotation about the spin axis, then the reflection
    c, s = np.cos(1.234), np.sin(1.234)
    rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, -1.0]],
                       dtype=torch.float32, device=dev)
    with torch.no_grad():
        rloc, rdir, rcap = sur.trace(entry @ rot.T, d @ rot.T)
    eq_loc = float((rloc - loc @ rot.T).abs().max())
    eq_dir = float((rdir - dir_ @ rot.T).abs().max())
    eq_cap = int((rcap != cap).sum())
    log(f"# phase 35: equivariance residual (rotation by 1.234 rad about "
        f"z and z -> -z): max |d loc| {eq_loc:.3e}, max |d dir| "
        f"{eq_dir:.3e}, {eq_cap} captures differ (a reading)")
    readings.setdefault("surrogate", {}).update(
        trace_f32_ms=times["f32"], trace_bf16_ms=times["bf16"],
        card_vs_cpu_dir=ddir, card_vs_cpu_loc=dloc,
        card_vs_cpu_loc_all=dloc_all,
        capture_flips=flips,
        bf16_dir=b_dir, bf16_capture_agree=agree, equivariance_loc=eq_loc,
        equivariance_dir=eq_dir, equivariance_captures=eq_cap)


def shadow_edges(img, n_ang=720):
    """bench.py _surrogate_image_compare's edge_radii: along 720 spokes
    from the image centre, the first radius outside the shadow (mean < 0.02)."""
    size = img.shape[0]
    mask = img.mean(-1) < 0.02
    cy = cx = (size - 1) / 2.0
    ang = np.linspace(0, 2 * np.pi, n_ang, endpoint=False)
    rr = np.arange(0, size // 2 - 2, 0.5)
    ys = np.clip((cy + rr[None, :] * np.sin(ang)[:, None]).round()
                 .astype(int), 0, size - 1)
    xs = np.clip((cx + rr[None, :] * np.cos(ang)[:, None]).round()
                 .astype(int), 0, size - 1)
    return rr[np.argmin(mask[ys, xs], axis=1)]


def phase_surrogate_train(dev, name_limit, readings):
    """train_surrogate at full width (256 x 5, a = 0.45, batch SUR_BATCH,
    SUR_STEPS steps): one rk4_fwd_kerr launch a step labels the batch;
    the loss falls to 0.6 of its first reading, evaluate_surrogate on
    SUR_EVAL rays reads capture accuracy > 0.9 and median direction error
    < 0.5 rad (the JAX CPU test's bars); K1's labels of one batch against
    the plain loop's (statuses equal but MAX_EDGE rays near b_c, the rest
    to the state tolerances); K1's time and bound on the batch; the
    hybrid frame of bench.py _surrogate_image_compare exact and through
    the model (PSNR and shadow-edge displacement, readings); save and load
    give the same trace bits."""
    cfg = SurrogateConfig()
    reset_counts()
    (sur, hist), train_ms = once(lambda: train_surrogate(
        generator(dev, 0), mass=0.5, spin=0.45, cfg=cfg, steps=SUR_STEPS,
        batch=SUR_BATCH, log_every=SUR_STEPS // 10))
    launches = read_counts()
    count_path(readings, "surrogate training", launches)
    check(launches == only(rk4_fwd_kerr=SUR_STEPS),
          f"training launched {launches}, expected rk4_fwd_kerr "
          f"{SUR_STEPS} times")
    ms_step = train_ms / SUR_STEPS
    log(f"# phase 36: train_surrogate 256x5, {SUR_STEPS} steps of "
        f"{SUR_BATCH} Kerr rays: {train_ms / 1e3:.3f} s, {ms_step:.3f} ms a "
        f"step [{name_limit}]")
    log("# phase 36: loss " + " ".join(f"{v:.4f}" for v in hist["loss"]))
    check(hist["loss"][-1] <= 0.6 * hist["loss"][0],
          "the surrogate's loss did not fall to 0.6 of its first reading")
    reset_counts()
    m = evaluate_surrogate(generator(dev, 2), sur, cfg, n=SUR_EVAL)
    count_path(readings, "surrogate evaluation", read_counts())
    log(f"# phase 36: evaluate_surrogate on {SUR_EVAL} rays: "
        + ", ".join(f"{k} {v:.5f}" for k, v in m.items())
        + " (limits: capture_acc > 0.9, dir_err_median_rad < 0.5)")
    check(m["capture_acc"] > 0.9 and m["dir_err_median_rad"] < 0.5,
          "the trained surrogate misses the JAX test's bars")

    # where a step's time goes: the loop's body on the trained weights
    env = _label_env(0.5, 0.45, cfg, dev)
    R = torch.tensor(cfg.r_influence, device=dev)
    params = [(w.detach().clone().requires_grad_(True),
               b.detach().clone().requires_grad_(True))
              for w, b in sur.params]
    opt, sched = surrogate._optimizer([t for pair in params for t in pair],
                                      3e-3, SUR_STEPS)
    gen = generator(dev, 4)
    entry, d = sample_entries(gen, SUR_BATCH, cfg, 0.5)

    def one_step():
        e, v = sample_entries(gen, SUR_BATCH, cfg, 0.5)
        with torch.no_grad():
            labels = label_rays(env, cfg, e, v)
        loss, _ = surrogate.surrogate_loss(params, cfg, R, e, v, *labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()

    step_ms = timed(one_step, runs=20)
    label_ms = timed(no_grad(lambda: label_rays(env, cfg, entry, d)),
                     runs=20)
    busy_ms, busy = step_profile(one_step, step_ms, "phase 36: a training "
                                 "step", name_limit)
    log(f"# phase 36: a training step: median {step_ms:.3f} ms, of which "
        f"label_rays {label_ms:.3f} ms; device busy {100 * busy:.1f}% "
        f"[{name_limit}]")

    # K1's labels of one batch against the plain loop's
    icfg = P.IntegratorConfig(n_steps=cfg.n_steps, dt=cfg.dt,
                              dt_boost=cfg.dt_boost)
    entry, d = sample_entries(generator(dev, 3), SUR_BATCH, cfg, 0.5)
    with torch.no_grad():
        lab_k = label_rays(env, cfg, entry, d)
        lab_p = label_rays(env, dataclasses.replace(cfg, backend="torch"),
                           entry, d)
        s0 = flat_state(initial_state(env, entry * (1.0 - 1e-4), d))
        sk = cuda_kernel.integrate_cuda(env, s0, icfg)
        sp = cuda_kernel.integrate_plain(env, s0, icfg)
    near = near_b_c(env, s0) | ulp_sensitive(env, icfg, s0, sp)
    flip = sk.status != sp.status
    label_flips = int(((lab_k[0] != lab_p[0]) | (lab_k[3] != lab_p[3]))
                      .sum())
    log(f"# phase 36: labels, K1 vs plain, {SUR_BATCH} rays: "
        f"{int(flip.sum())} statuses differ ({int((flip & ~near).sum())} "
        f"away from b_c), {label_flips} captured/escaped labels differ (at "
        f"most {MAX_EDGE}, near b_c)")
    check(int(flip.sum()) <= MAX_EDGE and not bool((flip & ~near).any())
          and label_flips <= MAX_EDGE,
          "K1's labels differ from the plain loop's away from b_c")
    keep = ~flip & ~near
    err, _ = compare_states(env, icfg, rays(sk, keep), rays(sp, keep),
                            f"surrogate labels {SUR_BATCH}, away from b_c")
    k1_frame("surrogate labels", env, icfg, s0, err, readings, name_limit)

    # bench.py _surrogate_image_compare: exact against the trained model
    scene, cam, hcfg, lcfg = hybrid_kerr_frame(dev)
    reset_counts()
    with torch.no_grad():
        exact = P.render_limited(scene, cam, hcfg, lcfg)[..., :3]
        approx = P.render_limited(scene, cam, hcfg, dataclasses.replace(
            lcfg, approx=True), table=sur)[..., :3]
    launches = read_counts()
    count_path(readings, "surrogate image", launches)
    check(launches == only(rk4_fwd_kerr=1) and bool(
        torch.isfinite(approx).all()),
          f"the surrogate image launched {launches} or is not finite")
    mse = float(((exact - approx) ** 2).mean())
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
    re_, ra_ = (shadow_edges(x.cpu().numpy()) for x in (exact, approx))
    edge = np.abs(re_ - ra_)
    log(f"# phase 36: {HYBRID}x{HYBRID} Kerr hybrid frame, trained model vs "
        f"the integrator: PSNR {psnr:.3f} dB, shadow-edge displacement "
        f"median {np.median(edge):.3f} px, p95 {np.percentile(edge, 95):.3f}"
        f" px, max {edge.max():.3f} px, shadow radius ~"
        f"{np.median(re_):.1f} px (readings)")

    # save and load: the same trace bits
    path = ROOT / "build" / "chip_smoke" / "surrogate.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    save_surrogate(path, sur)
    back = load_surrogate(path, device=dev)
    ev_e, ev_d = sample_entries(generator(dev, 2), SUR_EVAL, cfg, 0.5)
    with torch.no_grad():
        same = all(torch.equal(a, b) for a, b in zip(
            sur.trace(ev_e, ev_d), back.trace(ev_e, ev_d)))
    log("# phase 36: save_surrogate/load_surrogate: the trace of "
        f"{SUR_EVAL} rays " + ("equal bit for bit" if same else "DIFFERS"))
    check(same, "the reloaded surrogate traces other bits")
    readings.setdefault("surrogate", {}).update(
        train_s=train_ms / 1e3, ms_per_step=ms_step, steps=SUR_STEPS,
        step_ms=step_ms, label_ms=label_ms, step_device_busy=busy,
        loss_first=hist["loss"][0], loss_last=hist["loss"][-1], **m,
        label_status_flips=int(flip.sum()), psnr_db=psnr,
        edge_median_px=float(np.median(edge)),
        edge_p95_px=float(np.percentile(edge, 95)))


def phase_sharded(scene, cam, dev, name_limit, readings):
    """render_image_sharded on the one-rank mesh: the SIZE^2 flagship frame
    at one sample equals render_image bit for bit (rk4_fwd once); at five
    samples on the same draws (one rk4_fwd launch for the five) within
    SHARDED_MEAN mean |d|; render_stokes_sharded of phase 32's Stokes frame
    and polarization_map_sharded of the flagship's Schwarzschild map equal
    their unsharded forms; times."""
    cfg = flagship_cfg()
    reset_counts()
    with torch.no_grad():
        img = P.render_image_sharded(scene, cam, cfg)
    launches = read_counts()
    count_path(readings, "sharded frame", launches)
    check(launches == only(rk4_fwd=1),
          f"the sharded frame launched {launches}, expected rk4_fwd once")
    with torch.no_grad():
        ref = P.render_image(scene, cam, cfg)
    same = torch.equal(img, ref)
    cfg5 = dataclasses.replace(cfg, samples=ANIM_SAMPLES)
    draws = sample_draws(cfg5, dev)
    reset_counts()
    with torch.no_grad():
        img5 = P.render_image_sharded(scene, cam, cfg5, draws=draws)
    launches = read_counts()
    count_path(readings, "sharded frame, 5 samples", launches)
    with torch.no_grad():
        ref5 = P.render_image(scene, cam, cfg5, draws)
    d5 = (img5 - ref5).abs()
    log(f"# phase 37: render_image_sharded {SIZE}x{SIZE}: 1 sample "
        + ("equal to render_image bit for bit" if same else "DIFFERS")
        + f"; {ANIM_SAMPLES} samples on the same draws (launches "
        f"{launches}): mean |d| {float(d5.mean()):.3e}, max "
        f"{float(d5.max()):.3e} (limit {SHARDED_MEAN:g} mean)")
    check(same and float(d5.mean()) < SHARDED_MEAN
          and launches == only(rk4_fwd=1),
          "the sharded frame differs from render_image")

    sscene, scam = stokes_scene(dev), events_cam(dev)
    reset_counts()
    with torch.no_grad():
        got = render_stokes_sharded(sscene, scam, cfg)
        count_path(readings, "sharded Stokes frame", read_counts())
        want = P.render_stokes(sscene, scam, cfg)
        m = polarization_map_sharded(scene, cam, cfg)
        mref = P.polarization_map(scene, cam, cfg)
    st_same = all(torch.equal(a, b) for a, b in zip(got, want))
    m_same = torch.equal(torch.isnan(m), torch.isnan(mref)) and torch.equal(
        torch.nan_to_num(m), torch.nan_to_num(mref))
    log(f"# phase 37: render_stokes_sharded {SIZE}x{SIZE} "
        + ("equal to render_stokes bit for bit" if st_same else "DIFFERS")
        + f"; polarization_map_sharded {SIZE}x{SIZE} "
        + ("equal to polarization_map bit for bit" if m_same else "DIFFERS"))
    check(st_same and m_same, "a sharded Stokes frame or map differs")
    ms = timed(no_grad(lambda: P.render_image_sharded(scene, cam, cfg)),
               runs=5)
    ms5 = timed(no_grad(lambda: P.render_image_sharded(scene, cam, cfg5,
                                                       draws=draws)), runs=5)
    ms5_ref = timed(no_grad(lambda: P.render_image(scene, cam, cfg5,
                                                   draws)), runs=5)
    log(f"# phase 37: render_image_sharded {SIZE}x{SIZE}: median {ms:.3f} "
        f"ms; {ANIM_SAMPLES} samples {ms5:.3f} ms (render_image, one launch "
        f"a sample: {ms5_ref:.3f} ms) [{name_limit}]")
    readings.setdefault("trainer", {}).update(
        sharded_ms=ms, sharded_5spp_ms=ms5, render_5spp_ms=ms5_ref,
        sharded_5spp_mean_err=float(d5.mean()))


def trainer_scene(dev):
    """bench.py bench_sharded's scene (make_scene('sky')): the flagship sky
    around a hole of mass 0.5, camera (0, 0, 25), fov 0.8."""
    return (P.Scene(bh=P.BlackHole.make(mass=0.5, device=dev),
                    background=torch.as_tensor(make_sky(),
                                               dtype=torch.float32,
                                               device=dev)),
            P.Camera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8),
                          device=dev))


def sky_trainer(cfg, scene0, cam, mask=None, lr=0.0):
    """bench_sharded's make_trainer: SGD at ``lr`` on the mass, the camera
    position and the sky."""
    def param_fn(p):
        return (dataclasses.replace(
            scene0, bh=dataclasses.replace(scene0.bh, mass=p["mass"]),
            background=p["background"]),
            dataclasses.replace(cam, position=p["cam_pos"]))

    return P.Trainer(cfg=cfg, param_fn=param_fn,
                     optimizer=lambda ps: torch.optim.SGD(ps, lr=lr),
                     mask_critical=mask)


def sky_params(scene0, cam):
    return {"mass": torch.tensor(0.45, device=cam.position.device)
            .requires_grad_(True),
            "cam_pos": cam.position.detach().clone().requires_grad_(True),
            "background": scene0.background.detach().clone()
            .requires_grad_(True)}


def fit_scene(dev):
    """tests/test_parallel.py's sky (16x32) and camera (0, 0, 20), fov
    0.6."""
    h, w = 16, 32
    v = np.linspace(0.0, 1.0, h)[:, None]
    u = np.linspace(0.0, 1.0, w, endpoint=False)[None, :]
    uc = 0.5 + 0.5 * np.sin(2.0 * np.pi * u) * np.sin(np.pi * v)
    sky = torch.as_tensor(np.stack([
        np.broadcast_to(uc, (h, w)), np.broadcast_to(v, (h, w)),
        0.5 * np.ones((h, w))], -1), dtype=torch.float32, device=dev)
    cam = P.Camera.make(position=(0.0, 0.0, 20.0), fov=(0.6, 0.6),
                        device=dev)
    cfg = P.RenderConfig(width=16, height=12, samples=8, lam_max=60.0,
                         integrator=P.IntegratorConfig(n_steps=300, dt=0.1))

    def scene_of(mass):
        s = P.Scene(bh=P.BlackHole.make(mass=0.0, device=dev),
                    background=sky)
        return dataclasses.replace(s, bh=dataclasses.replace(s.bh,
                                                             mass=mass))

    trainer = P.Trainer(
        cfg=cfg, param_fn=lambda p: (scene_of(p["mass"]), cam),
        optimizer=lambda ps: torch.optim.Adam(ps, lr=2e-2), clip_norm=1.0)
    target = P.render_image(scene_of(torch.tensor(0.5, device=dev)), cam,
                            cfg)[..., :3]
    return trainer, target


def phase_trainer(dev, name_limit, readings):
    """The Trainer at full width (bench.py bench_sharded): one step at
    512^2 with mask_critical 0.25, the gradients to the mass, the camera
    position and the sky on the kernel path (rk4_ckpt and rk4_bwd once
    each) against the plain path, worst relative difference <
    TOL_TRAINER_GRAD (bench.py's gate); the 1024^2 step's time, loss,
    device busy share and K2/K3 device ms and bounds; and
    test_trainer_recovers_mass's fit (16x12, 8 samples, 60 Adam steps,
    clip 1) to within 0.05 of the mass."""
    scene0, cam = trainer_scene(dev)
    cfg = dataclasses.replace(flagship_cfg(), width=512, height=512)
    with torch.no_grad():
        target = P.render_image(scene0, cam, cfg)[..., :3]
    grads = {}
    for path, c in (("kernel", cfg), ("plain", plain(cfg))):
        tr = sky_trainer(c, scene0, cam, mask=0.25, lr=1.0)
        tf, ys, xs = tr.shard_target(target)
        p = sky_params(scene0, cam)
        p0 = {k: v.detach().clone() for k, v in p.items()}
        reset_counts()
        with shade_as(c):
            p, _, loss = tr.step(p, tr.init(p), tf, ys, xs)
        torch.cuda.synchronize()
        launches, shaded = read_counts(), read_shading()
        if path == "kernel":
            count_path(readings, "Trainer step 512", {**launches, **shaded})
            check(launches == only(rk4_ckpt=1, rk4_bwd=1)
                  and shaded == shading(fwd=1, bwd=1, tex=1),
                  f"the Trainer step launched {launches}, {shaded}, expected "
                  "rk4_ckpt, rk4_bwd, shade_fwd, shade_bwd and shade_tex "
                  "once each")
        grads[path] = {k: p0[k] - p[k].detach() for k in p0}
        log(f"# phase 38: Trainer.step 512x512, mask_critical 0.25, {path} "
            f"path: loss {float(loss):.6e}")
    errs = {k: rel_err(grads["kernel"][k], grads["plain"][k])
            for k in grads["kernel"]}
    worst = max(errs.values())
    log("# phase 38: Trainer gradient parity, kernel vs plain, 512x512: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; worst {worst:.3e} (limit {TOL_TRAINER_GRAD:g})")
    check(worst < TOL_TRAINER_GRAD,
          "the Trainer's gradients differ from the plain path's")

    # the 1024^2 step: time, loss, device busy share, K2 and K3
    cfg = flagship_cfg()
    with torch.no_grad():
        target = P.render_image(scene0, cam, cfg)[..., :3]
    tr = sky_trainer(cfg, scene0, cam)
    tf, ys, xs = tr.shard_target(target)
    p = sky_params(scene0, cam)
    st = tr.init(p)
    reset_counts()
    _, _, loss = tr.step(p, st, tf, ys, xs)
    torch.cuda.synchronize()
    launches = read_counts()
    count_path(readings, "Trainer step 1024", launches)
    step = lambda: tr.step(p, st, tf, ys, xs)  # noqa: E731
    wall = timed(step, runs=5)
    busy_ms, busy = step_profile(step, wall, f"phase 38: Trainer.step "
                                 f"{SIZE}x{SIZE}", name_limit)
    log(f"# phase 38: Trainer.step {SIZE}x{SIZE} (mass, camera, sky; SGD): "
        f"median {wall:.3f} ms, {SIZE * SIZE / wall * 1e3:.4e} rays/s, loss "
        f"{float(loss):.6e}, device busy {100 * busy:.1f}%, launches "
        f"{launches} [{name_limit}]")
    fenv, s0 = flagship_rays(scene0, cam, cfg, dev)
    s0 = flat_state(s0)
    icfg, seg = cfg.integrator, cuda_kernel.segment(cfg.integrator.n_steps)
    scal = cuda_kernel._scalars(fenv, icfg, dev)
    args = (scal, s0.x, s0.p, s0.E, s0.lam, s0.status)
    ckpt = no_grad(lambda: cuda_kernel.rk4_ckpt(*args, icfg.n_steps, seg,
                                                icfg.dt_power))
    ck = ckpt()[-1]
    g = torch.ones_like(s0.x)
    bwd = no_grad(lambda: cuda_kernel.rk4_bwd(scal, ck, s0.E, g, g,
                                              icfg.n_steps, seg,
                                              icfg.dt_power))
    ops, nbytes, (steps, _, _), _ = rk4_bound(fenv, icfg, s0)
    kernel_plain = plain_kernel_ms(fenv, s0, icfg)
    for kind, call in (("ckpt", ckpt), ("bwd", bwd)):
        r = dict(ms=timed(call), device_ms=device_ms(call),
                 plain_ms=kernel_plain[kind], rays=s0.E.numel(),
                 ray_steps=steps, **bound(ops[kind], nbytes[kind]))
        readings[f"rk4_{kind}"]["Trainer step"] = r
        log(f"# phase 38: rk4_{kind} on the Trainer step's {r['rays']} "
            f"rays: call {r['ms']:.3f} ms, device {r['device_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
            f"{r['plain_ms']:.3f} ms [{name_limit}]")
    del ck

    # test_trainer_recovers_mass on the card
    tr, target = fit_scene(dev)
    reset_counts()
    (params, losses), fit_ms = once(lambda: tr.fit({"mass": 0.35}, target,
                                                   n_steps=FIT_STEPS))
    launches = {**read_counts(), **read_shading()}
    count_path(readings, "mass fit", launches)
    mass = float(params["mass"])
    log(f"# phase 38: test_trainer_recovers_mass's fit on the card: mass "
        f"0.35 -> {mass:.6f} (limit |m - 0.5| < 0.05), loss "
        f"{losses[0]:.4e} -> min {min(losses):.4e} in {FIT_STEPS} steps, "
        f"{fit_ms:.3f} ms, launches {launches} [{name_limit}]")
    check(abs(mass - 0.5) < 0.05 and min(losses) < 0.5 * losses[0]
          and launches == only(rk4_ckpt=FIT_STEPS, rk4_bwd=FIT_STEPS,
                               shade_fwd=FIT_STEPS, shade_bwd=FIT_STEPS),
          "the mass fit did not recover the mass")
    readings.setdefault("trainer", {}).update(
        grad_parity=worst, step_ms=wall, step_loss=float(loss),
        device_busy_ms=busy_ms, device_busy=busy, fit_mass=mass,
        fit_ms=fit_ms)


def phase_checkpoint(dev, readings):
    """save_train_state and load_train_state mid-fit: the fit's Trainer
    three steps, a save, a load into a fresh optimizer, the fourth step;
    its params equal an uninterrupted run's fourth bit for bit, through
    torch.save and through npz."""
    tr, target = fit_scene(dev)
    tf, ys, xs = tr.shard_target(target)
    gen = generator(dev, 5)
    draws = [tr._draws(gen, dev) for _ in range(4)]

    def fresh():
        p = {"mass": torch.tensor(0.35, device=dev).requires_grad_(True)}
        return p, tr.init(p)

    p, st = fresh()
    for k in range(4):
        p, st, _ = tr.step(p, st, tf, ys, xs, draws[k])
    ref = p["mass"].detach().clone()
    base = ROOT / "build" / "chip_smoke"
    base.mkdir(parents=True, exist_ok=True)
    for suffix in (".pt", ".npz"):
        p, st = fresh()
        for k in range(3):
            p, st, _ = tr.step(p, st, tf, ys, xs, draws[k])
        path = str(base / f"train_state{suffix}")
        save_train_state(path, p, st, 3)
        p2, s2, step = load_train_state(path, like=(p, st))
        p = {k: v.clone().requires_grad_(True) for k, v in p2.items()}
        st = tr.init(p)
        st.load_state_dict(s2)
        p, st, _ = tr.step(p, st, tf, ys, xs, draws[3])
        same = torch.equal(p["mass"].detach(), ref) and step == 3
        log(f"# phase 39: checkpoint ({suffix}) after 3 of 4 steps, resumed:"
            f" the 4th step's mass {float(p['mass'].detach()):.9g} against "
            f"{float(ref):.9g} uninterrupted, "
            + ("equal bit for bit" if same else "DIFFERENT"))
        check(same, f"the resumed fit ({suffix}) differs from the "
              "uninterrupted one")


# =============================================================================
# The host surfaces: the native runtime, the CLI, the config, compat.
# =============================================================================
EXAMPLES = ROOT / "examples"
# (config, CLI flags, the launches of its render: one per row band of
# render_progressive at one sample a pixel, one per sample otherwise)
EXAMPLE_RENDERS = (
    ("disk_moons", ("--tonemap",), {"rk4_fwd_events": 16}),
    ("orbit_animation", ("--tonemap",), {"rk4_fwd_events": ANIM_SAMPLES}),
    ("kerr_disk", ("--tonemap",), {"rk4_fwd_kerr_events": 16}),
    ("einstein_ring_dopri", (), {"dopri_fwd_events": 16}),
    ("limited_hybrid", (), {"rk4_fwd": 1}),
    ("quickstart", (), {"rk4_fwd": 16}),
    ("stokes_polarization", ("--stokes",), {"rk4_fwd_events": 1}),
)
STATUS_NAMES = ("ACTIVE", "CAPTURED", "ESCAPED", "BUDGET", "DISK", "OBJECT",
                "INSIDE_HORIZON", "ERROR")


def quantize(img):
    """The host's quantization of a float frame, io_.write_png's."""
    return (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0
            + 0.5).astype(np.uint8)


class PlainCalls:
    """Counts the calls of the plain integrator (cuda_kernel.
    integrate_plain) inside the block: a path that should run the kernels
    calls it never."""

    def __enter__(self):
        self.n, self._orig = 0, cuda_kernel.integrate_plain

        def counted(*args, **kw):
            self.n += 1
            return self._orig(*args, **kw)

        cuda_kernel.integrate_plain = counted
        return self

    def __exit__(self, *exc):
        cuda_kernel.integrate_plain = self._orig


def run_cli(*argv):
    """``cli.main`` in this process on the card, its standard output
    captured; (its return value, the output, host ms)."""
    import contextlib
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = cli.main(["--device", DEVICE, *argv])
    torch.cuda.synchronize()
    return out, buf.getvalue(), (time.perf_counter() - t0) * 1e3


def frame_rays(scene, cam, cfg, dev):
    """A frame's environment and initial state over its whole (height,
    width) window, as render_image builds them."""
    ys, xs = pixel_grid(cfg.width, cfg.height, device=dev)
    o, d = generate_rays(cam, cfg.width, cfg.height, ys, xs)
    fenv = scene_env(scene, cfg, cam)
    return fenv, initial_state(fenv, o - scene.bh.loc, d)


def phase_native(dev, name_limit, readings):
    """The native runtime on the card's host: the library builds from the
    port's copy of the sources (or the phase fails with the compiler's
    message), its status codes are ops/states.py's, and the FrameWriter
    writes config 4's SIZE^2 uint8 frame (examples/orbit_animation.json,
    frame 1 of ANIM_FRAMES) so that it decodes back equal; the native
    encoder's ms against the pure-zlib encoder's on that frame."""
    if not NATIVE_BUILD:
        NATIVE_BUILD.update(zip(("ok", "s"), timed_native_build()))
    if not NATIVE_BUILD["ok"]:
        raise AssertionError(f"the native library did not build: "
                             f"{native.load_error()}")
    build_s = NATIVE_BUILD["s"]
    log(f"# phase 40: native library built and loaded in {build_s:.1f} s -> "
        f"{native._LIB_PATH.relative_to(ROOT)}")
    for name in STATUS_NAMES:
        check(getattr(native, name) == getattr(states, name),
              f"native.{name} differs from ops/states.py")
    cfg = load_config(str(EXAMPLES / "orbit_animation.json"))
    scene, cam, rcfg = build_scene(cfg, device=dev)
    r = float(np.linalg.norm(np.subtract(cfg.camera_location, cfg.bh_loc)))
    u8 = P.render_image_u8(scene, cli.orbit_camera(
        cam, cfg.bh_loc, r, 2 * np.pi / ANIM_FRAMES), rcfg).cpu().numpy()
    out = ROOT / "build" / "chip_smoke" / "native"
    out.mkdir(parents=True, exist_ok=True)
    path = str(out / "frame.png")
    with native.FrameWriter(threads=4) as fw:
        fw.submit(path, u8)
    same = (np.array_equal(read_png(path), u8)
            and np.array_equal(native.read_png(path), u8))
    log(f"# phase 40: FrameWriter wrote the {u8.shape} uint8 frame of "
        f"config 4 ({Path(path).stat().st_size / 1e6:.2f} MB); it decodes "
        + ("back equal" if same else "DIFFERENTLY"))
    check(same, "the FrameWriter's PNG does not decode to the frame")
    zpath = out / "zlib.png"
    ms = {"native": timed(lambda: native.write_png(path, u8), runs=5),
          "zlib": timed(lambda: zpath.write_bytes(_png_bytes(u8)), runs=5),
          "native, level 1": timed(lambda: native.write_png(
              str(out / "level1.png"), u8, compress_level=1), runs=5)}
    sizes = {k: Path(q).stat().st_size / 1e6 for k, q in (
        ("native", path), ("zlib", zpath), ("native, level 1",
                                            out / "level1.png"))}
    log(f"# phase 40: PNG encode+write of the {u8.shape} uint8 frame "
        "(median of 5): " + ", ".join(
            f"{k} {v:.3f} ms ({sizes[k]:.3f} MB)" for k, v in ms.items())
        + f" [{name_limit}]")
    readings["host"] = {"native_build_s": build_s,
                        "native_png_ms": ms["native"],
                        "zlib_png_ms": ms["zlib"],
                        "native_level1_png_ms": ms["native, level 1"]}


def example_reference(name, scene, cam, rcfg, cfg, dev):
    """(float image, plain image) of an example as the CLI renders it:
    render_stokes's rgb in the white frame (and its Q, U) for the Stokes
    example, render_limited for the hybrid, render_image for the rest; the
    plain one on the plain path."""
    if name == "stokes_polarization":
        out = [no_grad(lambda c=c: P.render_stokes(scene, cam, c))()
               for c in (rcfg, plain(rcfg))]
        return out
    if cfg.engine == "limited":
        lcfg, table = build_limited(cfg, device=dev)
        return [no_grad(lambda c=c: P.render_limited(
            scene, cam, c, lcfg, table=table))() for c in (rcfg, plain(rcfg))]
    return [no_grad(lambda c=c: P.render_image(scene, cam, c))()
            for c in (rcfg, plain(rcfg))]


def phase_examples(dev, name_limit, readings):
    """``cli render`` of every examples/*.json at its own size, in this
    process on the card: the kernel variant its path takes (K1 in its
    variant, or K4 for the Dormand-Prince ring) and no plain loop; the
    decoded PNG equal to the host quantization of the port's own render of
    build_scene(cfg) bit for bit; that render against the plain render by
    phase 27's image rule (disk_moons, orbit_animation, kerr_disk,
    quickstart), phase 23's (the ring), phase 33's (the hybrid) and phase
    32's (the Stokes frame: rgb, and Q and U where the statuses agree
    away from b_c and the ulp-sensitive rays, more than a row polarized);
    the Stokes example's _stokes.npz equal to render_stokes's planes; wall
    ms of each command."""
    out = ROOT / "build" / "chip_smoke" / "examples"
    out.mkdir(parents=True, exist_ok=True)
    walls = {}
    for name, flags, want in EXAMPLE_RENDERS:
        path = str(EXAMPLES / f"{name}.json")
        png = str(out / f"{name}.png")
        reset_counts()
        with PlainCalls() as pc:
            _, _, wall = run_cli("render", path, "-o", png, *flags)
        launches = read_counts()
        count_path(readings, f"cli render {name}", launches)
        walls[name] = wall
        check(launches == only(**want) and pc.n == 0,
              f"cli render {name} launched {launches} and the plain loop "
              f"{pc.n} times, expected {want}")
        cfg = load_config(path)
        scene, cam, rcfg = build_scene(cfg, device=dev)
        ref, ref_p = example_reference(name, scene, cam, rcfg, cfg, dev)
        if name == "stokes_polarization":
            (rgb, Q, U), (rgb_p, Q_p, U_p) = ref, ref_p
            img = torch.ones((rcfg.height, rcfg.width, 4), device=dev)
            img[..., :3] = rgb
            image_rule(rgb, rgb_p, f"{name} rgb, kernel vs plain",
                       FLAGSHIP_MEAN, FLAGSHIP_FRAC)
            # the frame's rays as phase 32 holds the Stokes frame's: final
            # states against the plain loop's (rays near b_c and those one
            # ulp moves held to lam within half a step), then Q and U within
            # TOL_STOKES on the rays whose status agrees, and more than a
            # row of polarized pixels.  Unlike phase 32, the rays near b_c
            # and the ulp-sensitive ones are left out of the Q/U bound
            # (their states are held above): on this frame a near-b_c disk
            # ray reads 1.123e-03, as far as two correct float32 paths part
            # there.  Their reading is logged.
            fenv, s0 = frame_rays(scene, cam, rcfg, dev)
            icfg = rcfg.integrator
            with torch.no_grad():
                s = cuda_kernel.integrate_cuda(fenv, s0, icfg)
                sp = cuda_kernel.integrate_plain(fenv, s0, icfg)
            near = near_b_c(fenv, s0) | ulp_sensitive(fenv, icfg, s0, sp)
            compare_events(fenv, icfg, flat_state(s0), flat_state(s),
                           flat_state(sp), f"{name} {rcfg.width}x"
                           f"{rcfg.height}", near.reshape(-1))
            same = s.status == sp.status
            dqu = torch.maximum((Q - Q_p).abs(), (U - U_p).abs())
            dq = masked_max(dqu, same & ~near)
            pol = int((torch.hypot(Q_p, U_p) > 1e-4).sum())
            log(f"# phase 41: {name}: Q/U on the {int((same & ~near).sum())} "
                f"rays whose status agrees away from b_c: max |d| {dq:.3e} "
                f"(limit {TOL_STOKES:g}); on the {int((same & near).sum())} "
                f"near it {masked_max(dqu, same & near):.3e} (a reading); "
                f"{pol} polarized pixels")
            check(dq <= TOL_STOKES and pol > rcfg.width,
                  f"{name}: Q/U differ from the plain render's")
            # the CLI's Stokes planes are the port's own render_stokes's
            npz = np.load(str(out / f"{name}_stokes.npz"))
            same_npz = all(np.array_equal(npz[k], v.cpu().numpy())
                           for k, v in (("rgb", rgb), ("Q", Q), ("U", U)))
            log(f"# phase 41: {name}: the CLI's _stokes.npz rgb/Q/U "
                + ("equal" if same_npz else "DIFFER from")
                + " render_stokes's")
            check(same_npz, f"cli render {name}: the _stokes.npz is not the "
                  "port's own render_stokes")
        else:
            img = ref
            if cfg.engine == "limited":
                hybrid_pixels(img, ref_p, f"{name}, kernel vs plain")
            elif cfg.method == "dopri":
                image_rule(img, ref_p, f"{name}, kernel vs plain",
                           GOLDEN_MEAN, GOLDEN_FRAC)
            else:
                image_rule(img, ref_p, f"{name}, kernel vs plain",
                           FLAGSHIP_MEAN, FLAGSHIP_FRAC)
        host = img.cpu().numpy()
        if "--tonemap" in flags:
            host = np.concatenate([tonemap(host[..., :3]), host[..., 3:]], -1)
        got = read_png(png)
        same_png = got.shape == host.shape and np.array_equal(got,
                                                              quantize(host))
        log(f"# phase 41: cli render {name} {rcfg.width}x{rcfg.height} x "
            f"{rcfg.samples} spp {' '.join(flags)}: {wall:.3f} ms, launches "
            f"{launches}; the PNG "
            + ("equals" if same_png else "DIFFERS from")
            + f" the host quantization of render(build_scene(cfg)) "
            f"[{name_limit}]")
        check(same_png, f"cli render {name}: the PNG is not the port's own "
              "render")
    readings.setdefault("host", {})["cli_render_ms"] = walls


def busy_share(fn):
    """(device busy ms, wall ms) of one call of ``fn`` traced through
    utils.profiling: the trace's kernels, memcpys and memsets summed
    against the call's host wall time (under the profiler)."""
    logdir = ROOT / "build" / "chip_smoke" / "busy_trace"
    shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.synchronize()
    with profiling.trace(str(logdir)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(dur for *_, dur in profiling._device_complete_events(
        profiling._load_trace_events(str(logdir)))) / 1e3
    shutil.rmtree(logdir, ignore_errors=True)
    return busy, wall


def phase_animate(dev, name_limit, readings):
    """``cli animate examples/orbit_animation.json`` at full width
    (BASELINE config 4: SIZE^2, ANIM_SAMPLES samples, ANIM_FRAMES frames)
    through the native FrameWriter: rk4_fwd_events ANIM_SAMPLES times a
    frame and nothing else; every frame decodes equal to render_image_u8
    of that frame's orbit camera; the last frame deleted and the command
    rerun with --resume, every file comes back byte-identical (the twin of
    tests/test_golden_baseline.py::test_animation_resume_bit_identical);
    frames/s (against phase 27's loop through the synchronous write) and
    the device's busy share over the command."""
    path = str(EXAMPLES / "orbit_animation.json")
    out = ROOT / "build" / "chip_smoke" / "animate"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    pat = str(out / "f_{frame:04d}.png")
    args = ("animate", path, "--frames", str(ANIM_FRAMES), "--out-pattern",
            pat)
    reset_counts()
    with PlainCalls() as pc:
        _, _, wall = run_cli(*args)
    launches = read_counts()
    count_path(readings, "cli animate", launches)
    check(launches == only(rk4_fwd_events=ANIM_SAMPLES * ANIM_FRAMES)
          and pc.n == 0,
          f"cli animate launched {launches} and the plain loop {pc.n} "
          f"times, expected rk4_fwd_events {ANIM_SAMPLES * ANIM_FRAMES}")
    files = [pat.format(frame=f) for f in range(ANIM_FRAMES)]
    data = [Path(p).read_bytes() for p in files]
    cfg = load_config(path)
    scene, cam, rcfg = build_scene(cfg, device=dev)
    r = float(np.linalg.norm(np.subtract(cfg.camera_location, cfg.bh_loc)))
    bad = []
    for f, p in enumerate(files):
        phi = 2 * np.pi * f / ANIM_FRAMES
        fcam = P.Camera.make(
            position=tuple(np.asarray(cfg.bh_loc) + r * np.asarray(
                [np.sin(phi), 0.0, np.cos(phi)])), euler=(0.0, phi, 0.0),
            fov=(cfg.field_of_view_x, cfg.field_of_view_y), device=dev)
        if not np.array_equal(read_png(p), P.render_image_u8(
                scene, fcam, rcfg).cpu().numpy()):
            bad.append(f)
    log(f"# phase 42: cli animate {ANIM_FRAMES} frames {rcfg.width}x"
        f"{rcfg.height} x {rcfg.samples} spp through the native FrameWriter "
        f"in {wall:.3f} "
        f"ms: {ANIM_FRAMES / wall * 1e3:.3f} frames/s (the command, scene "
        f"build included; phase 27's loop through the synchronous write "
        f"{readings.get('animation', {}).get('frames_per_s', math.nan):.3f})"
        f" [{name_limit}]; "
        f"frames not equal to render_image_u8 of their camera: {bad}")
    check(not bad, f"cli animate frames {bad} differ from render_image_u8")

    Path(files[-1]).unlink()
    reset_counts()
    run_cli(*args, "--resume")
    launches = read_counts()
    same = [Path(p).read_bytes() == d for p, d in zip(files, data)]
    log(f"# phase 42: the last frame deleted, --resume rendered it again "
        f"(launches {launches}): "
        + ("every file byte-identical" if all(same) else
           f"frames {[f for f, s in enumerate(same) if not s]} DIFFER"))
    check(all(same) and launches == only(rk4_fwd_events=ANIM_SAMPLES),
          "animate --resume is not byte-identical")

    shutil.rmtree(out)
    out.mkdir()
    busy, pwall = busy_share(lambda: run_cli(*args))
    log(f"# phase 42: cli animate under the profiler: device busy "
        f"{busy:.3f} ms of {pwall:.3f} ms wall, {100 * busy / pwall:.1f}% "
        f"[{name_limit}]")
    readings.setdefault("host", {}).update(
        animate_ms=wall, animate_frames_per_s=ANIM_FRAMES / wall * 1e3,
        animate_busy=busy / pwall)


def phase_compat(dev, name_limit, readings):
    """compat and the other subcommands: ``precompute-camera`` at its
    default 124^2 (one rk4_fwd launch), its ray_blackhole_hit and ray_end
    against the plain path on the card (hits equal but near b_c, exit
    points within TOL_X and directions within TOL_DIR away from it), its
    npz's save/load round trip; GeodesicIntegratorSchwarzschild's native
    backend against the torch one on a short fan (captures equal, as
    tests/test_native.py::test_compat_native_backend); ``train-surrogate``
    at limited_hybrid.json's mass, ratio and exit tolerance (200 steps,
    a = 0), a copy of that config with approx and the npz rendering
    through it and one with another ratio refused; ``profile-train --size
    256``: rk4_ckpt and rk4_bwd in its op table, a collective share of 0."""
    out = ROOT / "build" / "chip_smoke" / "compat"
    out.mkdir(parents=True, exist_ok=True)
    npz = str(out / "camera.npz")
    reset_counts()
    _, _, pre_ms = run_cli("precompute-camera", "-o", npz)
    launches = read_counts()
    count_path(readings, "cli precompute-camera", launches)
    check(launches == only(rk4_fwd=1),
          f"precompute-camera launched {launches}, expected rk4_fwd once")
    # the CLI's file is RelativisticCamera.run's launch on the card; that
    # launch's rays against the plain path's as phase 3 holds the
    # flagship's (statuses equal, the state tolerances away from b_c,
    # rays a step apart at a boundary aligned)
    rc = compat.RelativisticCamera(device=dev)
    env, o, d, icfg = rc.setup()
    s0 = flat_state(initial_state(env, o, d))
    with torch.no_grad():
        sk = cuda_kernel.integrate_cuda(env, s0, icfg)
        sp = cuda_kernel.integrate_plain(env, s0, icfg)
        dk = final_direction(env, sk)
    h, w = rc.resolution
    hit_k = ((sk.status == states.CAPTURED)
             | (sk.status == states.INSIDE_HORIZON)).reshape(h, w)
    with np.load(npz) as z:
        same = (np.array_equal(z["ray_blackhole_hit"],
                               hit_k.cpu().numpy().astype(np.int8))
                and np.array_equal(z["ray_end"], torch.cat(
                    [sk.x, dk], -1).reshape(h, w, 6).cpu().numpy()))
    e, n_al, lam_band = compare_flagship(env, icfg, s0, sk, sp,
                                         f"precompute-camera {h}x{w}")
    log(f"# phase 43: precompute-camera {h}x{w} in {pre_ms:.3f} ms: "
        f"{int(hit_k.sum())} captures; the npz "
        + ("equals" if same else "DIFFERS from")
        + f" rk4_fwd's launch of its rays; against the plain path error "
        f"{e:.3e}, {n_al} rays aligned a step apart [{name_limit}]")
    check(same, "precompute-camera's npz is not its rays' rk4_fwd launch")
    back = compat.RelativisticCamera().load(npz)
    rc.run()
    saved = rc.save(str(out / "again.npz"))
    again = compat.RelativisticCamera().load(saved)
    same = (np.array_equal(back.ray_end, rc.ray_end)
            and np.array_equal(back.ray_blackhole_hit, rc.ray_blackhole_hit)
            and np.array_equal(again.ray_end, rc.ray_end)
            and back.resolution == again.resolution == (h, w))
    check(same, "the camera npz does not round-trip")

    b = np.asarray([1.0, 2.0, 2.4, 2.8, 3.5, 6.0])
    x0 = np.stack([b, np.zeros_like(b), np.full_like(b, 30.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (len(b), 1))
    res = {be: compat.GeodesicIntegratorSchwarzschild(
        mass=0.5, backend=be, device=dev).calc_trajectory(
            d0, x0, max_step=0.1 if be == "native" else 0.05,
            curve_end=300.0)[2] for be in ("native", "torch")}
    agree = np.array_equal(res["native"]["hit_blackhole"],
                           res["torch"]["hit_blackhole"])
    log(f"# phase 43: compat native vs torch backends on the b = {b.tolist()}"
        f" fan: captures {res['native']['hit_blackhole'].tolist()} and "
        f"{res['torch']['hit_blackhole'].tolist()}")
    check(agree, "the native and torch compat backends capture different "
          "rays")

    sur = str(out / "surrogate.npz")
    reset_counts()
    _, text, train_ms = run_cli("train-surrogate", "--steps", "200", "--a", "0",
                            "--mass", "0.5", "--ratio", "12",
                            "--exit-tolerance", "0.1", "-o", sur)
    launches = read_counts()
    count_path(readings, "cli train-surrogate", launches)
    log(f"# phase 43: train-surrogate 200 steps in {train_ms:.3f} ms, launches "
        f"{launches}: " + " ".join(text.split()))
    check(set(launches) == {"rk4_fwd"} and Path(sur).exists(),
          f"train-surrogate launched {launches}")
    base = json.loads((EXAMPLES / "limited_hybrid.json").read_text())
    good = out / "hybrid_approx.json"
    good.write_text(json.dumps(dict(base, approx=True, surrogate_path=sur)))
    png = str(out / "hybrid_approx.png")
    reset_counts()
    run_cli("render", str(good), "-o", png)
    launches = read_counts()
    count_path(readings, "cli render hybrid approx", launches)
    cfg = load_config(str(good))
    scene, cam, rcfg = build_scene(cfg, device=dev)
    lcfg, table = build_limited(cfg, device=dev)
    ref = no_grad(lambda: P.render_limited(scene, cam, rcfg, lcfg,
                                           table=table))().cpu().numpy()
    same = np.array_equal(read_png(png), quantize(ref))
    log(f"# phase 43: limited_hybrid.json with approx and the surrogate: "
        f"rendered through it (launches {launches}), the PNG "
        + ("equals" if same else "DIFFERS from") + " render_limited's")
    check(same and np.isfinite(ref).all(), "the approx render through the "
          "trained surrogate is not render_limited's")
    bad = out / "hybrid_bad.json"
    bad.write_text(json.dumps(dict(base, approx=True, surrogate_path=sur,
                                   ratio_obj_to_blackhole=20.0)))
    try:
        run_cli("render", str(bad), "-o", str(out / "bad.png"))
        refused = False
    except ValueError as e:
        refused = "ratio_obj_to_blackhole" in str(e)
    check(refused, "a surrogate for another ratio was not refused")

    reset_counts()
    rep, text, prof_ms = run_cli("profile-train", "--size", "256")
    launches = read_counts()
    count_path(readings, "cli profile-train", launches)
    op_text = text.split("(top 15):")[-1].split("collectives:")[0]
    log(f"# phase 43: profile-train --size 256 in {prof_ms:.3f} ms, launches "
        f"{launches} [{name_limit}]:")
    for line in text.strip().splitlines():
        log(f"#   {line}")
    check("rk4_bwd" in op_text and "rk4_ckpt" in op_text
          and rep["collective_share"] == 0,
          "profile-train's table lacks rk4_bwd or rk4_ckpt, or has "
          "collectives on one rank")
    readings.setdefault("host", {}).update(
        precompute_ms=pre_ms, train_surrogate_ms=train_ms,
        profile_train_ms=prof_ms)


# =============================================================================
# The last slice: utils.profiling and the example programs.
# =============================================================================
# profile_steps' rk4_fwd device ms a step against phase 7's CUDA events
PROFILE_AGREE = 0.2
# parameter_study's deflection angles, card against the CPU plain loop
TOL_DEFLECTION = 1e-4
# the example programs' arguments besides --device: their defaults
EXAMPLE_ARGV = {"parameter_study": (), "kerr_faraday": (), "fit_orbit": (),
                "tutorial": ()}
# transport stages kerr_faraday's busy share is profiled over
FARADAY_BUSY_STAGES = 20


def phase_profiling(scene, cam, dev, name_limit, readings):
    """utils.profiling on the card: ``profile_steps`` over the flagship
    SIZE^2 forward render (one warm-up, 10 traced), its op table naming
    the rk4_fwd kernel at a device ms a step within PROFILE_AGREE of phase
    7's CUDA-event time; ``device_memory_stats`` with 0 < peak <= limit;
    ``profile_collectives`` of the same render on one rank: share 0,
    overlap NaN.  (``profile-train``'s table, read by the same module,
    names rk4_ckpt and rk4_bwd in phase 43.)"""
    cfg = flagship_cfg()
    fwd = no_grad(lambda: P.render_image(scene, cam, cfg))
    reset_counts()
    rows = profiling.profile_steps(fwd, repeats=10, top=12)
    rep = profiling.profile_collectives(fwd, repeats=3)
    launches = read_counts()
    count_path(readings, "utils.profiling", launches)
    log(f"# phase 44: profile_steps, flagship forward {SIZE}x{SIZE}, 10 "
        f"steps; launches {launches} [{name_limit}]:")
    for line in profiling.format_op_table(rows).splitlines():
        log(f"#   {line}")
    prof_ms = sum(ms for name, ms, _ in rows if "rk4_fwd" in name)
    event_ms = readings["rk4_fwd"].get("device_ms", math.nan)
    rel = abs(prof_ms / event_ms - 1.0)
    log(f"# phase 44: rk4_fwd {prof_ms:.3f} ms a step in the op table, "
        f"{event_ms:.3f} ms by CUDA events (phase 7): {100 * rel:.1f}% apart"
        f" (limit {100 * PROFILE_AGREE:g}%) [{name_limit}]")
    check(launches == only(rk4_fwd=15), f"profiling launched {launches}")
    check(prof_ms > 0 and rel <= PROFILE_AGREE,
          "the op table's rk4_fwd time is not phase 7's")
    stats = profiling.device_memory_stats()
    mem = stats.get(str(dev))
    log(f"# phase 44: device_memory_stats {json.dumps(stats)}")
    check(mem is not None and 0 < mem["peak_bytes_in_use"]
          <= mem["bytes_limit"], "device_memory_stats: not 0 < peak <= "
          "limit")
    log(f"# phase 44: profile_collectives on one rank: "
        f"{json.dumps(rep)}")
    check(rep["collective_share"] == 0 and math.isnan(
        rep["overlap_fraction"]), "collectives reported on one rank")
    readings.setdefault("examples", {})["profile_rk4_fwd_ms"] = prof_ms


def example_argv(name):
    """The example's arguments on the card: EXAMPLE_ARGV[name], its outputs
    under build/chip_smoke/<name>/."""
    return [*EXAMPLE_ARGV[name], "--outdir",
            str(ROOT / "build" / "chip_smoke" / name), "--device", DEVICE]


def run_example(name, mod, readings, name_limit):
    """``mod.main`` on the card (example_argv), in this process, its output
    logged: (wall s, launches), the shading kernels' among them.  The
    launches go to the kernels line's ``launches_by_path``; the example
    must exit 0 and not call the plain loop."""
    import contextlib
    import io

    argv = example_argv(name)
    buf = io.StringIO()
    reset_counts()
    with PlainCalls() as pc, contextlib.redirect_stdout(buf):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {**read_counts(), **read_shading()}
    count_path(readings, f"example {name}", launches)
    log(f"# example {name} {' '.join(argv)}: exit {rc} in {wall:.3f} s, "
        f"launches {launches} [{name_limit}]")
    for line in buf.getvalue().splitlines():
        log(f"#   {line}")
    check(rc == 0, f"example {name} exited with {rc}")
    check(pc.n == 0, f"example {name} called the plain loop {pc.n} times")
    return wall, launches


def example_busy(name, fn, wall, launches, name_limit, readings):
    """Log and record the device's busy share of ``fn`` (busy_share)
    beside the example's unprofiled wall seconds and launches."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        busy_ms, prof_ms = busy_share(fn)
    share = busy_ms / prof_ms
    log(f"# example {name}: {wall:.3f} s, launches {launches}; device busy "
        f"{busy_ms:.3f} ms of {prof_ms:.3f} ms = {100 * share:.1f}% "
        f"(profiler) [{name_limit}]")
    readings.setdefault("examples", {})[name] = {
        "wall_s": wall, "busy_share": share,
        "launches": sum(launches.values())}


def quiet_main(name, mod):
    """A run of the example as run_example's, its launches not counted."""
    return lambda: mod.main(example_argv(name))


def phase_example_study(dev, name_limit, readings):
    """examples.parameter_study on the card: one rk4_fwd (a = 0) or
    rk4_fwd_kerr launch of one ray a bisection step, one rk4_fwd of the
    deflection fan, one rk4_fwd_events and one shade_fwd a disk frame, no
    plain loop; its
    Bardeen (< 1%), deflection-series and beaming checks inside the
    script; the deflection angles against the CPU plain loop's on the same
    impact parameters within TOL_DEFLECTION rad; the device's busy
    share."""
    name = "parameter_study"
    wall, launches = run_example(name, parameter_study, readings,
                                    name_limit)
    check(set(launches) == {"rk4_fwd", "rk4_fwd_kerr", "rk4_fwd_events",
                            "shade_fwd"}
          and launches["shade_fwd"] == launches["rk4_fwd_events"],
          f"{name} launched {launches}")
    with open(ROOT / "build" / "chip_smoke" / name /
              "parameter_study.json") as f:
        rep = json.load(f)
    worst = max(max(r["rel_err"]) for r in rep["shadow_edges"])
    m = rep["mass"]
    bs = np.asarray([r["b_over_M"] for r in rep["deflection"]]) * m
    n_steps = 6000 if "--quick" in EXAMPLE_ARGV[name] else 8000
    card = np.asarray([r["measured_rad"] for r in rep["deflection"]])
    cpu = parameter_study.measure_deflection(m, bs, n_steps=n_steps,
                                             device="cpu")
    err = float(np.abs(card - cpu).max())
    log(f"# phase 45: shadow edges against Bardeen: worst {worst:.3e} "
        f"(limit 0.01); deflection of {len(bs)} rays, card against the CPU "
        f"plain loop: max |d| {err:.3e} rad (limit {TOL_DEFLECTION:g})")
    check(worst < 0.01, f"{name}: shadow edges off Bardeen's")
    check(err <= TOL_DEFLECTION, f"{name}: deflection differs from the "
          "plain loop's")
    example_busy(name, quiet_main(name, parameter_study), wall, launches,
                 name_limit, readings)
    readings["examples"][name].update(bardeen_worst=worst,
                                      deflection_err=err)


def phase_example_faraday(dev, name_limit, readings):
    """examples.kerr_faraday on the card (the transport ODE: no kernel);
    its three signatures inside the script; its a = 0 map (the npz's)
    against the same map on the CPU by compare_maps within TOL_POL on the
    escaped rays away from b_c; the busy share of FARADAY_BUSY_STAGES
    transport stages at the example's size and a = 0.45."""
    name = "kerr_faraday"
    wall, launches = run_example(name, kerr_faraday, readings,
                                    name_limit)
    check(launches == {}, f"{name} launched {launches}")
    size, n_steps = 96, 600
    argv = EXAMPLE_ARGV[name]
    if "--size" in argv:
        size = int(argv[argv.index("--size") + 1])
    if "--n-steps" in argv:
        n_steps = int(argv[argv.index("--n-steps") + 1])
    card = np.load(str(ROOT / "build" / "chip_smoke" / name /
                        "kerr_faraday.npz"))["excess_a0"]
    cpu, cpu_ms = once(lambda: kerr_faraday.excess_map(0.0, size, n_steps,
                                                       "cpu"))
    o3, d3, _ = kerr_faraday.equatorial_rays(size, "cpu")
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    env = GeodesicEnv(mass=f(0.5), r_capture=f(1.0),
                      r_escape=f(2 * kerr_faraday.D), lam_max=f(1e9))
    near = near_b_c(env, initial_state(env, o3, d3)).reshape(size, size)
    held, other = compare_maps(torch.from_numpy(card), torch.from_numpy(cpu),
                               ~near, f"{name} a = 0, card vs CPU", TOL_POL)
    log(f"# phase 46: {name} a = 0 map {size}x{size}: card vs CPU {held:.3e}"
        f" rad away from b_c, {other:.3e} near it; the CPU map "
        f"{cpu_ms:.3f} ms [{name_limit}]")

    o3, d3, f0 = kerr_faraday.equatorial_rays(size, dev)
    stages = no_grad(lambda: transport_polarization_ode(
        kerr_ks_metric(0.5, 0.45), o3, d3, f0, n_steps=FARADAY_BUSY_STAGES,
        dt=0.08, r_stop=2 * kerr_faraday.D, dt_boost=16.0, r_ref=1.6))
    stages()
    example_busy(name, stages, wall, launches, name_limit, readings)
    readings["examples"][name].update(map_err=held, cpu_map_ms=cpu_ms)


def phase_example_fit(dev, name_limit, readings):
    """examples.fit_orbit on the card: the targets through rk4_fwd and
    shade_fwd (one launch each a frame for all its samples), each fit step
    one rk4_ckpt, one rk4_bwd, one shade_fwd and one shade_bwd (the sky
    frozen: no texture scatter), no plain loop; its exit
    code is the script's < 1%
    recovery of mass, orbit phase and roll; the busy share."""
    name = "fit_orbit"
    wall, launches = run_example(name, fit_orbit, readings, name_limit)
    with open(ROOT / "build" / "chip_smoke" / name /
              "fit_orbit_result.json") as f:
        rep = json.load(f)
    steps = len(rep["losses"])
    frames = rep["config"]["frames"]
    check(launches == only(rk4_fwd=frames, rk4_ckpt=steps, rk4_bwd=steps,
                           shade_fwd=frames + steps, shade_bwd=steps),
          f"{name} launched {launches}")
    log(f"# phase 47: {name}: loss {rep['loss_first']:.4e} -> "
        f"{rep['loss_last']:.4e} in {steps} steps, errors "
        f"{json.dumps(rep['errors'])}, fit {rep['fit_seconds']:.3f} s "
        f"[{name_limit}]")
    example_busy(name, quiet_main(name, fit_orbit), wall, launches,
                 name_limit, readings)
    readings["examples"][name].update(errors=rep["errors"],
                                      fit_s=rep["fit_seconds"])


def phase_example_tutorial(dev, name_limit, readings):
    """examples.tutorial on the card: rk4_fwd (the fan, the hybrid frame,
    the table's build, the surrogate's labels and evaluation),
    rk4_fwd_events (the scene, its sharded and Stokes renders), shade_fwd
    (the renders through render_rays), the mass gradient through
    rk4_ckpt_events, rk4_bwd_events and shade_bwd (the sky, disk and moon
    frozen: no texture scatter), no plain loop;
    its three PNGs; the busy share."""
    name = "tutorial"
    wall, launches = run_example(name, tutorial, readings, name_limit)
    check(set(launches) == {"rk4_fwd", "rk4_fwd_events", "rk4_ckpt_events",
                            "rk4_bwd_events", "shade_fwd", "shade_bwd"},
          f"{name} launched {launches}")
    out = ROOT / "build" / "chip_smoke" / name
    for png in ("tutorial_disk.png", "tutorial_limited_mlp.png",
                "tutorial_polfrac.png"):
        check((out / png).exists(), f"{name} wrote no {png}")
    example_busy(name, quiet_main(name, tutorial), wall, launches,
                 name_limit, readings)


def tex_terms(saved):
    """The plain path's four (rows, columns, weights) of the corners, from
    what sample_bpy's forward saved."""
    _, _, _, _, tx, ty, xi0, xi1, yi0, yi1 = saved
    txe, tye = tx[..., None], ty[..., None]
    return ((yi0, xi0, (1.0 - txe) * (1.0 - tye)),
            (yi0, xi1, txe * (1.0 - tye)),
            (yi1, xi0, (1.0 - txe) * tye), (yi1, xi1, txe * tye))


def tex_saved(tex, x, y, learn_tex):
    """(the tensors sample_bpy's forward saves for (tex, x, y), the
    texture's shape, whether dtex is wanted): the arguments of the
    backward's two paths but g."""
    leaf = lambda t, on: t.detach().clone().requires_grad_(on)  # noqa
    out = sample_bpy(leaf(tex, learn_tex), leaf(x, True), leaf(y, True))
    return out.grad_fn.saved_tensors, tuple(tex.shape), learn_tex


def tex_reference(saved, g, shape):
    """tex_bwd.cu's fixed-point dtex taken with torch -- each finite term
    g w scaled by 2^k (k: cuda_kernel.tex_bwd_exponent of the largest
    finite |g|), rounded to int64, summed by index_add_ (integers: any
    order gives the same) and back to float32 -- and each texel's bound
    on the distance of the plain path's dtex from it (the module comment
    at TOL_TEX_XY)."""
    h, w, nc = shape
    a = g.abs()
    a = a[torch.isfinite(a)]
    k = cuda_kernel.tex_bwd_exponent(float(a.max()) if a.numel() else 0.0,
                                     saved[4].numel())
    acc = torch.zeros(h * w * nc, dtype=torch.int64, device=g.device)
    count = torch.zeros(h * w * nc, dtype=torch.float64, device=g.device)
    mass = torch.zeros_like(count)
    ch = torch.arange(nc, device=g.device)
    for yi, xi, wgt in tex_terms(saved):
        idx = ((yi * w + xi)[..., None] * nc + ch).reshape(-1)
        v = (g * wgt).reshape(-1).double()
        acc.index_add_(0, idx, torch.where(
            torch.isfinite(v), torch.round(v * 2.0 ** k), 0.0).to(torch.int64))
        count.index_add_(0, idx, torch.ones_like(v))
        mass.index_add_(0, idx, v.abs())
    bound = (count + 1) * 2.0 ** -24 * mass + count * 2.0 ** -(k + 1)
    return ((acc.double() * 2.0 ** -k).float().reshape(shape),
            bound.reshape(shape))


def tex_check(what, call, g):
    """One backward of the texture sampler through tex_bwd against the
    plain path on the card (module comment at TOL_TEX_XY), and a second
    run bit for bit; returns the kernel's (dtex, dx, dy) and its largest
    |difference| from the plain path's over their largest |value|."""
    saved, shape, dtex = call
    kd, kx, ky = cuda_kernel.tex_bwd(*saved, g, shape, dtex)
    pd, px, py = sample_bpy_bwd_plain(*saved, g, shape, dtex)
    again = cuda_kernel.tex_bwd(*saved, g, shape, dtex)
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    check(all(a is b or torch.equal(bits(a), bits(b))
              for a, b in zip((kd, kx, ky), again)),
          f"{what}: two runs of tex_bwd differ")
    errs = []
    for got, want, name in ((kx, px, "dx"), (ky, py, "dy")):
        fin = torch.isfinite(want)
        check(torch.equal(torch.isfinite(got), fin)
              and torch.equal(torch.isnan(got), torch.isnan(want)),
              f"{what}: {name}'s non-finite entries differ from the plain "
              "path's")
        err = float((got - want)[fin].abs().max()
                    / want[fin].abs().max().clamp(min=1e-30)) if bool(
                        fin.any()) else 0.0
        check(err <= TOL_TEX_XY, f"{what}: {name} {err:.3e} of its largest "
              f"value from the plain path's, outside {TOL_TEX_XY:.3e}")
        errs.append(err)
    if dtex:
        fp, bound = tex_reference(saved, g, shape)
        fin = torch.isfinite(pd)
        for name, cls in (("NaN", torch.isnan), ("+inf", torch.isposinf),
                          ("-inf", torch.isneginf)):
            check(torch.equal(cls(kd), cls(pd)),
                  f"{what}: dtex's {name} texels differ from the plain "
                  "path's")
        err = (kd.double() - pd.double()).abs()
        share = float((err[fin] / bound[fin].clamp(min=1e-300)).max()) if bool(
            fin.any()) else 0.0
        check(bool((err[fin] <= bound[fin]).all()),
              f"{what}: dtex outside the float32 summation bound of the "
              f"plain path (worst texel at {share:.3f} of it)")
        check(torch.equal(bits(kd[fin]), bits(fp[fin])),
              f"{what}: dtex differs from the fixed-point sum taken with "
              "torch")
        rel = float((err[fin]).max() / pd[fin].abs().max().clamp(
            min=1e-30)) if bool(fin.any()) else 0.0
        log(f"# phase 49 [{what}]: dtex {rel:.3e} of its largest |value| "
            f"from the plain path's (worst texel at {share:.3f} of the "
            f"summation bound); dx, dy {errs[0]:.3e}, {errs[1]:.3e}")
        errs.append(rel)
    return (kd, kx, ky), max(errs)


def phase_tex_bwd(dev, name_limit, readings):
    """The texture sampler's backward through csrc/tex_bwd.cu at the orbit
    fit's shapes (the module comment at TOL_TEX_XY): the six sample_bpy
    calls of config 4's frame 1 at SIZE^2 x ANIM_SAMPLES samples in one
    call with a TEX_SKY sky (the sky, whose dtex is wanted, the disk and
    the four moons, whose are not), captured from the plain shading of the
    final state of one render_samples (frame_state);
    each against the plain path, two runs bit for bit, each call launching
    tex_bwd_dtex or tex_bwd once; the seam and pole batches of
    tests/test_torch_grad.py::test_sample_bpy_backward_matches_jax; a g
    with NaN and infinities, and an all-zero g; the warps' texel groups;
    the six calls' device ms against their bound, the plain path's and
    the sky's four index_put_."""
    sky = torch.as_tensor(make_sky(*TEX_SKY, 32), dtype=torch.float32,
                          device=dev)
    scene = dataclasses.replace(events_scene(dev), background=sky)
    env, scene_bh, s = frame_state(
        scene, frame_cam(2 * np.pi / ANIM_FRAMES, dev), anim_cfg(), dev)
    seen, apply = [], texture._SampleBpy.apply

    def capture(tex, x, y):
        seen.append((tex, x.detach(), y.detach()))
        return apply(tex, x, y)

    with torch.no_grad(), unittest.mock.patch.object(
            texture._SampleBpy, "apply", capture):
        shade(scene_bh, s, final_direction(env, s))
    calls = [tex_saved(t, x, y, t.data_ptr() == sky.data_ptr())
             for t, x, y in seen]
    n = calls[0][0][4].numel()
    check(len(calls) == 6 and sum(c[2] for c in calls) == 1
          and all(c[0][4].numel() == n for c in calls)
          and n == ANIM_SAMPLES * SIZE * SIZE,
          f"the frame made {len(calls)} sample_bpy calls of "
          f"{[c[0][4].numel() for c in calls]} rays, expected six of "
          f"{ANIM_SAMPLES * SIZE * SIZE}, one on the sky")
    gen = torch.Generator(device=dev)
    gen.manual_seed(49)
    gs = [torch.randn(c[0][0].shape, generator=gen, device=dev)
          for c in calls]
    cuda_kernel.LAUNCHES.clear()
    for i, (call, g) in enumerate(zip(calls, gs)):
        _, err = tex_check(f"call {i} ({'sky' if call[2] else 'frozen'} "
                           f"{call[1]})", call, g)
        r = readings["tex_bwd_dtex" if call[2] else "tex_bwd"]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_kernel.LAUNCHES.items() if v}
    check(launches == {"tex_bwd_dtex": 2, "tex_bwd": 10},
          f"two runs of the six calls launched {launches}, expected "
          "tex_bwd_dtex 2 and tex_bwd 10")
    for name, k in launches.items():
        readings[name]["launches"] = k
    # the seam and pole batches of the CPU test, and the edge cases of g
    rng = np.random.default_rng(5)
    small = torch.as_tensor(rng.uniform(size=(16, 32, 3)),
                            dtype=torch.float32, device=dev)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    for where, seed in (("seam", 5), ("poles", 6)):
        rng = np.random.default_rng(seed)
        xy = [rng.uniform(-0.95, 0.95, 4000) for _ in range(2)]
        edge = rng.uniform(0.96, 1.0, 4000) * rng.choice([-1.0, 1.0], 4000)
        xy[where == "poles"] = edge
        _, err = tex_check(where, tex_saved(small, f32(xy[0]), f32(xy[1]),
                                            True),
                           f32(rng.normal(size=(4000, 3))))
        r = readings["tex_bwd_dtex"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
    sky_call, g = calls[0], gs[0]
    bad = g.clone()
    bad.view(-1)[::100_003] = float("nan")
    bad.view(-1)[7::100_019] = float("inf")
    bad.view(-1)[11::100_043] = float("-inf")
    tex_check("g with NaN and infinities", sky_call, bad)
    (kd, _, _), _ = tex_check("all-zero g", sky_call, torch.zeros_like(g))
    check(int(torch.count_nonzero(kd)) == 0, "all-zero g: dtex not zero")
    # the warps' texel groups on the sky call: lanes a leader, atomics a ray
    _, _, _, _, _, _, xi0, _, yi0, yi1 = sky_call[0]
    key = ((yi0 * TEX_SKY[1] + xi0) * 2 + (yi1 - yi0)).reshape(-1)
    key = torch.cat([key, key.new_full(((-n) % 32,), -1)]).reshape(-1, 32)
    groups = int((torch.sort(key, dim=1).values.diff(dim=1) != 0).sum()
                 + key.shape[0])
    per_texel = torch.bincount((yi0 * TEX_SKY[1] + xi0).reshape(-1))
    log(f"# phase 49: the sky call's {n} rays fall in {groups} warp "
        f"groups, {n / groups:.2f} lanes a leader: {4 * groups / n:.3f} "
        f"atomics a ray and channel instead of 4; "
        f"{int((per_texel > 0).sum())} texel cells hit, "
        f"{float(per_texel[per_texel > 0].float().mean()):.1f} rays a cell "
        f"on average, {int(per_texel.max())} at most")
    # times: the six calls of a step through the kernel, the plain path,
    # and the sky's four accumulating index_put_ alone
    def step(bwd):
        for call, g in zip(calls, gs):
            bwd(*call[0], g, call[1], call[2])

    def index_puts():
        out = gs[0].new_zeros(sky_call[1])
        for yi, xi, wgt in tex_terms(sky_call[0]):
            out.index_put_((yi, xi), gs[0] * wgt, accumulate=True)

    # the work of a call: dx, dy read the corners, tx, ty and g and write
    # dx, dy (14 operations a channel, 4 a ray); the texture cotangent
    # also reads the four indices and writes dtex once (the weights, and
    # a product and a scaling a corner and channel)
    nc = sky_call[1][2]
    ray_bytes = n * (4 * nc * 4 + 8 + nc * 4 + 8)
    ray_ops = n * (14 * nc + 4)
    tex_bytes = n * 32 + sky_call[0][0].element_size() * (
        TEX_SKY[0] * TEX_SKY[1] * nc)
    bytes_ = 6 * ray_bytes + tex_bytes
    bound_ms = bytes_ / PEAK_BYTES * 1e3
    ms = device_ms(lambda: step(cuda_kernel.tex_bwd))
    plain_ms = device_ms(lambda: step(sample_bpy_bwd_plain), runs=3)
    put_ms = device_ms(index_puts, runs=3)
    # each variant on one call: the sky's with dtex, the disk's without
    for name, (call, g), ops, nbytes in (
            ("tex_bwd_dtex", (sky_call, gs[0]), ray_ops + n * (8 * nc + 4),
             ray_bytes + tex_bytes),
            ("tex_bwd", (calls[1], gs[1]), ray_ops, ray_bytes)):
        one = lambda bwd: lambda: bwd(*call[0], g, call[1], call[2])  # noqa
        readings[name].update(
            ms=timed(one(cuda_kernel.tex_bwd)),
            device_ms=device_ms(one(cuda_kernel.tex_bwd)),
            plain_ms=device_ms(one(sample_bpy_bwd_plain), runs=3),
            **bound(ops, nbytes))
        r = readings[name]
        log(f"# {name} [one call, {n} rays]: call {r['ms']:.3f} ms, device "
            f"{r['device_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, plain {r['plain_ms']:.3f} ms [{name_limit}]")
    sky_ms = readings["tex_bwd_dtex"]["device_ms"]
    log(f"# tex_bwd [the orbit fit's six calls a step, {n} rays, sky "
        f"{TEX_SKY[0]}x{TEX_SKY[1]}]: device {ms:.3f} ms (the sky's "
        f"{sky_ms:.3f}), bound {bound_ms:.3f} ms ({bytes_ / 1e9:.2f} GB at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s), plain {plain_ms:.3f} ms, the sky's "
        f"four index_put_ {put_ms:.3f} ms; launches a step: tex_bwd_dtex "
        f"1, tex_bwd 5 [{name_limit}]")


def frame_state(scene, cam, cfg, dev):
    """(env, the scene in the hole's frame, the final state) of one
    render_samples of the SIZE^2 pixels at cfg.samples samples (all in one
    integrator launch, as the Trainer renders them), captured where
    render_rays shades them, under torch.no_grad."""
    pix = torch.arange(SIZE * SIZE, device=dev)
    ys, xs = pix // SIZE, pix % SIZE
    jitter = slot_jitter(cfg, sample_draws(cfg, dev), ys, xs)
    seen, real = [], renderer.shade_rays

    def grab(env, scene_bh, s):
        seen.append((env, scene_bh, s))
        return real(env, scene_bh, s)

    with torch.no_grad(), unittest.mock.patch.object(renderer, "shade_rays",
                                                     grab):
        render_samples(scene, cam, cfg, ys, xs, jitter)
    env, scene_bh, s = seen[0]
    flat = lambda t: t.reshape((-1,) + t.shape[2:]).contiguous()  # noqa: E731
    return env, scene_bh, dataclasses.replace(
        s, **{k: flat(getattr(s, k))
              for k in ("x", "p", "E", "lam", "status", "hit_obj")})


def kerr_cell_frame(dev):
    """The Kerr cell's face-on frame (gpubench/configs/kerr_disk_1024.json:
    a = 0.45, M = 0.5, a beaming disk 1.6-6.0 of intensity 1.2, no moons,
    500 RK4 steps of 0.1 grown to 64x) with a TEX_SKY sky: (scene, camera,
    render config)."""
    v, u = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    disk_tex = np.stack([0.9 + 0 * u, 0.5 + 0.3 * np.sin(8 * np.pi * u / 256),
                         0.2 + 0 * u], -1)
    scene = P.Scene(
        bh=P.BlackHole.make(mass=0.5, spin=0.45, device=dev),
        background=torch.as_tensor(make_sky(*TEX_SKY, 32),
                                   dtype=torch.float32, device=dev),
        disk=P.Disk.make(r_in=1.6, r_out=6.0, texture=disk_tex,
                         intensity=1.2, beaming=4.0, device=dev))
    cam = P.Camera.make(position=(0.0, 0.0, 24.74), fov=(0.8, 0.8),
                        device=dev)
    cfg = anim_cfg()
    cfg = dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, n_steps=500, dt=0.1))
    return scene, cam, cfg


def shade_grads(env, scene_bh, s, g, kernel):
    """(colours, cotangents of x, p, E, the sky, the mass and, for a Kerr
    hole, the spin) of sum(g * colour) through the shading kernels or the
    plain shading."""
    leaf = lambda t: t.detach().clone().requires_grad_(True)  # noqa: E731
    bh = scene_bh.bh
    mass = leaf(bh.mass)
    spin = None if bh.spin is None else leaf(bh.spin)
    scene = dataclasses.replace(
        scene_bh, bh=dataclasses.replace(bh, mass=mass, spin=spin),
        background=leaf(scene_bh.background))
    env = dataclasses.replace(env, mass=mass, spin=spin)
    s = dataclasses.replace(s, x=leaf(s.x), p=leaf(s.p), E=leaf(s.E))
    out = (shade_rays(env, scene, s) if kernel
           else shade(scene, s, final_direction(env, s)))
    leaves = [s.x, s.p, s.E, scene.background, mass] + (
        [] if spin is None else [spin])
    return out.detach(), torch.autograd.grad((out * g).sum(), leaves)


def scalar_terms(env, scene_bh, s, g):
    """The plain shading's per-ray terms of the mass's and, for a Kerr
    hole, the spin's cotangent of sum(g * colour): autograd with the hole's
    scalars expanded to one a ray."""
    n = g.shape[0]
    bh = scene_bh.bh
    per_ray = lambda t: t.detach().expand(n).clone().requires_grad_(True)  # noqa: E731
    mass = per_ray(bh.mass)
    spin = None if bh.spin is None else per_ray(bh.spin)
    scene = dataclasses.replace(scene_bh, bh=dataclasses.replace(
        bh, mass=mass, spin=spin))
    env = dataclasses.replace(env, mass=mass, spin=spin)
    out = shade(scene, s, final_direction(env, s))
    return torch.autograd.grad((out * g).sum(),
                               [mass] + ([] if spin is None else [spin]))


def ray_gaps(a, b):
    """Each ray's gap between per-ray cotangents a and b (n, ...): its
    largest |a - b| over the larger of its largest |b| and the rays' 99.9th
    percentile of that (tests/shade_cases.py ray_gaps); 0 where b is not
    finite."""
    n = b.shape[0]
    a, b = a.reshape(n, -1), b.reshape(n, -1)
    ok = torch.isfinite(b).all(-1)
    mag = torch.where(ok, b.abs().max(-1).values,
                      torch.zeros(n, device=b.device))
    scale = max(float(torch.quantile(mag[ok][::4].double(), 0.999)), 1e-30)
    gap = (a - b).abs().max(-1).values / torch.clamp_min(mag, scale)
    return torch.where(ok, gap, torch.zeros_like(gap))


def phase_shade(dev, name_limit, readings):
    """The shading kernels at the two cells' frames (the module comment at
    TOL_SHADE_FRAME): colours, cotangents, repeatability, launches, times
    and bounds."""
    sky = torch.as_tensor(make_sky(*TEX_SKY, 32), dtype=torch.float32,
                          device=dev)
    moon_tex = np.random.default_rng(50).uniform(0.0, 1.0, (4, 16, 32, 3))
    orbit = (dataclasses.replace(events_scene(dev, moon_tex=moon_tex),
                                 background=sky),
             frame_cam(2 * np.pi / ANIM_FRAMES, dev), anim_cfg())
    for tag, (scene, cam, cfg) in (("orbit", orbit),
                                   ("Kerr", kerr_cell_frame(dev))):
        kerr = scene.bh.spin is not None
        suffix = "_kerr" if kerr else ""
        env, scene_bh, s = frame_state(scene, cam, cfg, dev)
        n = s.E.numel()
        gen = torch.Generator(device=dev)
        gen.manual_seed(50)
        g = torch.randn((n, 3), generator=gen, device=dev)
        reset_counts()
        out_k, gk = shade_grads(env, scene_bh, s, g, kernel=True)
        torch.cuda.synchronize()
        shaded = read_shading()
        check(shaded == shading(kerr, fwd=1, bwd=1, tex=1) and
              read_counts() == {},
              f"{tag}: the shading's forward and backward launched "
              f"{shaded}, {read_counts()}")
        for name in (f"shade_fwd{suffix}", f"shade_bwd{suffix}"):
            readings[name]["launches"] = 1
        readings["shade_tex"].setdefault("launches", 0)
        readings["shade_tex"]["launches"] += 1
        _, again = shade_grads(env, scene_bh, s, g, kernel=True)
        check(all(torch.equal(a, b) for a, b in zip(gk, again)),
              f"{tag}: two backward runs differ")
        out_p, gp = shade_grads(env, scene_bh, s, g, kernel=False)
        dc = (out_k - out_p).abs().max(-1).values
        parted = dc > TOL_SHADE_FRAME
        gaps = {"colour": float(dc[~parted].max())}
        for name, a, b in zip(("x", "p", "E"), gk[:3], gp[:3]):
            check(bool(torch.isfinite(a).all()),
                  f"{tag}: the kernel's {name} cotangent not finite")
            d = ray_gaps(a, b)
            parted |= d > TOL_SHADE_RAY
            gaps[name] = float(d[d <= TOL_SHADE_RAY].max())
        n_part = int(parted.sum())
        check(n_part <= MAX_SHADE_PARTED * n,
              f"{tag}: {n_part} rays part from the plain path's")
        with torch.no_grad():
            pole = final_direction(env, s)[:, :2].norm(dim=-1) < SKY_POLE_CAP
        g_kept = torch.where((parted | pole)[:, None], 0.0, g)
        _, gk2 = shade_grads(env, scene_bh, s, g_kept, kernel=True)
        _, gp2 = shade_grads(env, scene_bh, s, g_kept, kernel=False)
        gaps["sky"] = rel_err(gk2[3], gp2[3])
        check(gaps["sky"] <= TOL_SHADE_SCENE,
              f"{tag}: the sky cotangent {gaps['sky']:.3e} from the plain "
              "path's")
        for name, a, t in zip(("mass", "spin"), gk2[4:],
                              scalar_terms(env, scene_bh, s, g_kept)):
            t = t.double()
            gaps[name] = float((a.double() - t.sum()).abs() / t.abs().sum())
            check(gaps[name] <= TOL_SHADE_RAY,
                  f"{tag}: the {name} cotangent {gaps[name]:.3e} of its "
                  "terms' magnitudes from the plain path's")
        log(f"# phase 50 [{tag}, {n} rays]: {n_part} rays part (largest "
            f"colour gap {float(dc.max()):.3e}), {int(pole.sum())} within "
            f"{SKY_POLE_CAP} of the sky's pole; the others' gaps: "
            + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
            + " (the mass's and the spin's over the sum of their terms' "
            "magnitudes)")
        # times: the forward; the backward without and with the sky's
        # texture cotangent (the kernel, the column sums; then the scatter,
        # its finish and the scratch's fill)
        ss = shade_scene(scene_bh)
        fwd = no_grad(lambda: cuda_kernel.shade_cuda(ss, s))
        args = (ss, s.x, s.p, s.E, s.status, s.hit_obj, g)
        bwd = lambda: cuda_kernel.shade_bwd(*args, need=(False,) * 3)  # noqa
        bwd_tex = lambda: cuda_kernel.shade_bwd(  # noqa: E731
            *args, need=(True, False, False))
        plain_fwd = no_grad(lambda: shade(scene_bh, s,
                                          final_direction(env, s)))

        def plain_step():
            shade_grads(env, scene_bh, s, g, kernel=False)

        def kernel_step():
            shade_grads(env, scene_bh, s, g, kernel=True)

        n_sph, texels = ss.n_sph, TEX_SKY[0] * TEX_SKY[1]
        tex_bytes = 4 * sum(t.numel() for t in (ss.sky, ss.disk_tex,
                                                ss.sph_tex) if t is not None)
        ncol = cuda_kernel.NSH + 8 * n_sph
        blocks = -(-n // 256)
        fwd_bytes = n * 48 + tex_bytes
        bwd_bytes = n * 76 + tex_bytes + 8 * ncol * blocks
        total = 3 * texels
        tex_extra = (n * 48 + 2 * 8 * (total + -(-total // 16) + 1)
                     + 4 * total)
        step_plain = device_ms(plain_step, runs=3)
        step_kernel = device_ms(kernel_step)
        rows = ((f"shade_fwd{suffix}", fwd, fwd_bytes,
                 device_ms(plain_fwd, runs=3)),
                (f"shade_bwd{suffix}", bwd, bwd_bytes, step_plain),
                ("shade_tex", bwd_tex, bwd_bytes + tex_extra, step_plain))
        for name, fn, nbytes, plain_ms in rows:
            if name == "shade_tex" and kerr:
                log(f"# shade_tex [Kerr, {n} rays, the backward with the "
                    f"sky's cotangent]: device {device_ms(fn):.3f} ms, bound "
                    f"{nbytes / PEAK_BYTES * 1e3:.4f} ms [{name_limit}]")
                continue
            err = (gaps["colour"] if name.startswith("shade_fwd")
                   else max(v for k, v in gaps.items() if k != "colour"))
            readings[name].update(
                max_abs_err=err, ms=timed(fn), device_ms=device_ms(fn),
                plain_ms=plain_ms, **bound(0, nbytes))
            r = readings[name]
            log(f"# {name} [{tag}, {n} rays]: call {r['ms']:.3f} ms, device "
                f"{r['device_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
                f"bytes ({nbytes / 1e9:.3f} GB; operations not counted), "
                f"plain {plain_ms:.3f} ms [{name_limit}]")
        log(f"# shading [{tag}, {n} rays]: forward and backward with the "
            f"sky's cotangent through the kernels {step_kernel:.3f} ms of "
            f"device time, the plain shading and its autograd "
            f"{step_plain:.3f} ms [{name_limit}]")


def main() -> int:
    # --- phase 0: the card -----------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name_limit = card()
    log(name_limit)
    dev = torch.device(DEVICE, 0)

    if Path(P.__file__).resolve().parent != ROOT / PKG:
        raise RuntimeError(f"{PKG} imported from {P.__file__}, not from "
                           f"this checkout ({ROOT})")
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")

    t_start = time.perf_counter()
    phase_build()
    readings = {name: {} for name in KERNELS}
    env = fan_env(dev)
    icfg = flagship_cfg().integrator
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, device=dev),
                    background=torch.as_tensor(make_sky(),
                                               dtype=torch.float32,
                                               device=dev))
    cam = P.Camera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8),
                        device=dev)

    phase("phase 2 (rk4_fwd vs plain)", phase_fwd, env, icfg, dev, readings)
    phase("phase 3 (flagship forward)", phase_flagship_fwd, scene, cam, dev,
          readings)
    phase("phase 4 (rk4_ckpt)", phase_ckpt, env, icfg, scene, cam, dev,
          readings)
    phase("phase 5 (rk4_bwd vs autograd)", phase_bwd, env, icfg, dev,
          readings)
    phase("phase 6 (flagship gradient)", phase_flagship_grad, scene, cam,
          dev, readings)
    phase_times(scene, cam, dev, name_limit, readings)
    phase("phase 8 (rk4_fwd events vs plain)", phase_events_fwd, env, icfg,
          dev, readings)
    phase("phase 9 (rk4_ckpt events)", phase_events_ckpt, env, icfg, dev,
          readings)
    phase("phase 10 (rk4_bwd events vs autograd)", phase_events_bwd, env,
          icfg, dev, readings)
    phase("phase 11 (events frame)", phase_events_render, dev, readings)
    phase_events_times(dev, name_limit, readings)
    phase("phase 13 (Kerr rk4_fwd vs plain)", phase_kerr_fwd, icfg, dev,
          readings)
    phase("phase 14 (Kerr rk4_ckpt)", phase_kerr_ckpt, icfg, dev, readings)
    phase("phase 15 (Kerr rk4_bwd vs autograd)", phase_kerr_bwd, icfg, dev,
          readings)
    phase("phase 16 (Kerr events frame)", phase_events_render, dev,
          readings, 0.45)
    phase_events_times(dev, name_limit, readings, spin=0.45)
    phase("phase 18 (Kerr integrator)", phase_kerr_integrator, dev,
          name_limit, readings)
    phase("phase 19 (bounds)", phase_bounds, dev, name_limit, readings)
    phase("phase 20 (dopri_fwd vs plain)", phase_dopri_fwd, dev, readings)
    phase("phase 21 (dopri_ckpt)", phase_dopri_ckpt, dev, readings)
    phase("phase 22 (dopri_bwd vs autograd)", phase_dopri_bwd, dev, readings)
    phase("phase 23 (Einstein ring)", phase_dopri_ring, dev, name_limit,
          readings)
    phase("phase 24 (Kerr Einstein ring)", phase_dopri_ring, dev, name_limit,
          readings, 0.45)
    phase("phase 25 (adaptive rows)", phase_dopri_adaptive, dev, name_limit,
          readings)
    phase("phase 25 (Kerr adaptive rows)", phase_dopri_adaptive, dev,
          name_limit, readings, 0.45)
    phase("phase 26 (Dormand-Prince bounds)", phase_dopri_bounds, dev,
          name_limit, readings)
    phase("phase 27 (animation frame)", phase_anim_fwd, dev, name_limit,
          readings)
    phase("phase 28 (animation gradient)", phase_anim_grad, dev, name_limit,
          readings)
    phase("phase 29 (progressive, stats, debug)", phase_anim_outputs, dev,
          readings)
    phase("phase 30 (timelike fan)", phase_timelike, dev, name_limit,
          readings)
    phase("phase 31 (metrics, Kerr polarization map)",
          phase_polarization_kerr, dev, name_limit, readings)
    phase("phase 32 (Stokes frame, Schwarzschild polarization map)",
          phase_stokes, dev, name_limit, readings)
    phase("phase 33 (Gen-1 hybrid)", phase_hybrid, dev, name_limit,
          readings)
    phase("phase 34 (full-size goldens)", phase_goldens, dev, readings)
    phase("phase 35 (surrogate inference)", phase_surrogate_infer, dev,
          name_limit, readings)
    phase("phase 36 (surrogate training)", phase_surrogate_train, dev,
          name_limit, readings)
    phase("phase 37 (sharded renders)", phase_sharded, scene, cam, dev,
          name_limit, readings)
    phase("phase 38 (Trainer)", phase_trainer, dev, name_limit, readings)
    phase("phase 39 (checkpoint)", phase_checkpoint, dev, readings)
    phase("phase 40 (native runtime)", phase_native, dev, name_limit,
          readings)
    phase("phase 41 (cli render of the examples)", phase_examples, dev,
          name_limit, readings)
    phase("phase 42 (cli animate)", phase_animate, dev, name_limit, readings)
    phase("phase 43 (compat and the other subcommands)", phase_compat, dev,
          name_limit, readings)
    phase("phase 44 (utils.profiling)", phase_profiling, scene, cam, dev,
          name_limit, readings)
    phase("phase 45 (example parameter_study)", phase_example_study, dev,
          name_limit, readings)
    phase("phase 46 (example kerr_faraday)", phase_example_faraday, dev,
          name_limit, readings)
    phase("phase 47 (example fit_orbit)", phase_example_fit, dev,
          name_limit, readings)
    phase("phase 48 (example tutorial)", phase_example_tutorial, dev,
          name_limit, readings)
    phase("phase 49 (texture backward)", phase_tex_bwd, dev, name_limit,
          readings)
    phase("phase 50 (shading kernels)", phase_shade, dev, name_limit,
          readings)
    log(f"# chip_smoke ran {time.perf_counter() - t_start:.1f} s, the "
        "kernels' build included")

    for name in KERNELS:
        missing = [k for k in KERNEL_KEYS if k not in readings[name]]
        check(not missing, f"{name}: no reading of {missing}")
    if FAILURES:
        log(f"# chip_smoke FAILED {len(FAILURES)} check(s):")
        for msg in FAILURES:
            log(f"#   {msg}")
        return 1
    for what, v in readings.pop("kerr_integrator").items():
        log(f"# Kerr integrator [bench.py's kerr row, {INTEGRATOR_RAYS} "
            f"rays]: {what} "
            f"{v:.3f} ms [{name_limit}]")
    for key, what in (("step", "flagship"), ("step_events", "events"),
                      ("step_kerr_events", "Kerr events")):
        step = readings.pop(key)
        log(f"# step [{what}]: forward+backward {step['fwd_bwd_ms']:.3f} ms "
            f"({SIZE * SIZE / (step['fwd_bwd_ms'] * 1e-3):.4e} rays/s), "
            f"plain {step['fwd_bwd_plain_ms']:.3f} ms, forward "
            f"{step['fwd_ms']:.3f} ms [{name_limit}]")
    for key in ("ring_events", "ring_kerr_events"):
        v = readings.pop(key)
        log(f"# step [{key[5:]} Einstein ring {RING}x{RING}, Dormand-Prince]:"
            f" forward {v['fwd_ms']:.3f} ms, forward+backward "
            f"{v['fwd_bwd_ms']:.3f} ms, plain {v['fwd_bwd_plain_ms']:.3f} ms "
            f"[{name_limit}]")
    for key in ("adaptive", "adaptive_kerr"):
        v = readings.pop(key)
        log(f"# bench.py adaptive row [{key}, {ADAPTIVE_RAYS} rays]: forward "
            f"{v['fwd_ms']:.3f} ms, forward+gradient {v['fwd_grad_ms']:.3f} "
            f"ms, plain {v['fwd_grad_plain_ms']:.3f} ms [{name_limit}]")
    v = readings.pop("animation")
    log(f"# animation [BASELINE config 4, {SIZE}x{SIZE} x {ANIM_SAMPLES} "
        f"spp]: float frame {v['frame_ms']:.3f} ms, uint8 frame "
        f"{v['u8_frame_ms']:.3f} ms, PNG write {v['png_ms']:.3f} ms, "
        f"{v['frames_per_s']:.3f} frames/s; "
        f"forward+backward {v['step_ms']:.3f} ms (plain "
        f"{v['step_plain_ms']:.3f} ms), device busy "
        f"{100 * v['device_busy']:.1f}%; K2 checkpoints "
        f"{v['ckpt_bytes'] / 2**20:.1f} MiB per step [{name_limit}]")
    v = readings.pop("polarization")
    log(f"# polarization: Kerr map {POL_KERR}x{POL_KERR} (transport ODE) "
        f"{v['kerr_map_ms']:.3f} ms; Stokes frame {SIZE}x{SIZE} "
        f"{v['stokes_ms']:.3f} ms (plain {v['stokes_plain_ms']:.3f} ms); "
        f"Schwarzschild map {SIZE}x{SIZE} {v['schw_map_ms']:.3f} ms (plain "
        f"{v['schw_map_plain_ms']:.3f} ms) [{name_limit}]")
    v = readings.pop("hybrid")
    t = v.pop("surrogate table")
    log(f"# Gen-1 hybrid {HYBRID}x{HYBRID}: "
        + ", ".join(f"{k} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms)"
                    for k, r in v.items())
        + f"; SurrogateTable.build {t['build_ms']:.3f} ms, approx frame "
        f"{t['approx_frame_ms']:.3f} ms [{name_limit}]")
    for key in ("goldens", "surrogate", "trainer", "host", "examples"):
        for k, v in readings.pop(key, {}).items():
            log(f"# {key}: {k} = {v} [{name_limit}]")
    # a variant's launches: its earlier main path's and this slice's
    for name in KERNELS:
        r = readings[name]
        by = r.pop("launches_by_path", {})
        if by:
            r["launches_by_path"] = {"earlier": r["launches"], **by}
            r["launches"] = sum(r["launches_by_path"].values())
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **readings[name]}
        for name, (src, rep) in KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
