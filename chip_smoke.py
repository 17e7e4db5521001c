#!/usr/bin/env python3
"""Chip smoke test of cednerf_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass (nothing is caught and carried on):

  1. device: needs CUDA (exits 1 without it, printing no result); prints
     the card's name and power limit as nvidia-smi reports them;
  2. build: nvcc builds the port's CUDA sources from the checkout,
     one nvcc per source, all started together;
  3. kernels: K1 (interp_fwd) and K5 (fused_encode_fwd) against their plain
     PyTorch versions at one full seg-eval pass (eval_chunk_seg 32768 x
     budget_per_ray 64 = 2,097,152 samples) and at a ragged N; K6
     (fused_encode_bwd) and K2 (interp_bwd_fused) at one train step's
     262,144 samples and at a ragged N, all 8 levels, tables of +-8; K5, K1
     and K6 also on every intra cell and on cell and brick boundaries of
     each level at F = 1, 2, 4 (K5 and K1 in both output dtypes), and K6 on
     a batch whose samples all lie in one level-0 brick; K4
     (compact_select) bit-exact on [256, 1024] and [16000, 1024] lattices
     (the warmup and top ray buckets) at occupancy 1.0 and ~0.1, budget
     262,144. Each is timed with CUDA events beside its bound on uniform
     random samples, K5, K6 and K2 also on ray-major ones (32,768 and
     4,096 rays of one 400x400 camera, 64 samples each, as a seg-eval pass
     and a packed step order them); K4 and torch.nonzero also by their device
     time per call under torch.profiler (bench.device_ms), which leaves out
     the host time between calls that the events count;
  4. reference: a small frame rendered on the card (kernel route) and on
     the CPU (plain route) from the same weights and grid must agree (see
     reference_phase for why the check can fail);
  5. serving: ViewerServer on 127.0.0.1 answers /, /snap and five /render
     requests from the D-NeRF field at full width (dnerf_config with
     -te -ta -f -df: L8 F4, dst resolution 1024, 2^21 hashmap, 16384-row
     cap, brick layout; random weights from --seed), every frame a finite
     PNG; four on the K5 route, one on K1 (interp_impl="interp"). Launch
     counters are zeroed just before the requests and read just after;
  6. reference step: one train step of a shrunken config on the card (both
     kernel routes) and on the CPU (plain versions), from the same weights,
     occupancy grid, ray batch and march jitter: loss and every gradient
     must agree (see reference_step_phase);
  7. training: Trainer.run_step on the full-width field (dnerf_config,
     -te -ta -f -ae -df -d) over BallCloudScene for TRAIN_STEPS steps on
     the default route (the 256-step all-cells occupancy warmup and sampled
     updates after it), then INTERP_STEPS steps on the K1/K2 route. Every
     loss must be finite and the last 8 default steps' mean PSNR above the
     first 8's; counters zeroed before each route and read after it: K5, K6
     and K4 on the default steps, K1, K2 and K4 on the interp steps, no
     plain version on CUDA in either;
  8. K3 (scatter_add_rows) against its plain version on the corner
     entries of one real backward of the full-width 4D keyframe field
     (--grid_type hash4d: 3 dense and 5 hashed levels, K = 4; an F-wide
     entry a (keyframe slot, sample, corner), key keyframe row * 64 +
     corner) at the train step's 262,144 samples, on level 0 (864
     keyframe rows, the most contended) and on a hashed level (65,536
     rows), the hashed level also in the [2N, 64F] update-row form of the
     parent design (the same sums), on a ragged M = 100,003 of random rows
     and on the full-width tri-plane encoder's texel gradient (25.2M
     entries of F = 4 columns, K3's narrow rows); each timed with CUDA
     events beside its bound and index_add_, with float atomics and under
     torch.use_deterministic_algorithms(True);
  8b. the key-width sort (key_sort, from both libraries that export it)
     bit-exact against torch.sort(stable=True), sorted keys and
     permutation, on K6's 2,097,152 keys of a train step (uniform, and all
     samples in one level-0 brick), the hash4d hashed level's 4.2M corner
     keys, the tri-plane's 25.2M texel keys, a ragged 100,003 with keys
     out of range and 2,097,152 equal keys; timed beside torch.sort, by
     events and by profiler device time (a window that kept every call),
     with each of its kernels' device time and the kernels a sort
     launches; one sort dispatched under set_sync_debug_mode("error"). It
     runs in a new process of this script (--sort_phase), as does phase
     18's kernel part (--repro_kernels): late in a run the profiler keeps
     too few device records for a reading;
  9. hash4d reference step: phase 6 for the 4D field (its backward on K3
     on the card, on the plain version on the CPU);
 10. hash4d training: Trainer.run_step on the full-width 4D field for
     HASH4D_STEPS steps; finite losses, rising PSNR, K3 launched 8 times a
     step (one per level) and K4 once, no K1/K2/K5/K6 and no plain version
     on CUDA; then one 400x400 frame at 128 samples of the trained field
     through ViewerServer, finite;
 11. interp_enc probe: K7 (interp_bwd) against its plain version on the
     full-width field's levels (tables +-8, as phase 3) at the probe's N =
     262,144 and at a ragged N, timed beside its bound; then
     cednerf_torch.tools.profile_interp_enc.run at its defaults (L8 F4, max
     res 1024, 2^19 hashmap, N = 262,144), counters zeroed just before and
     read just after: K1's forward within one bf16 ulp of brick_encode's
     (K5), K7 + one K3 per level within 1e-4 of the K6 route's table
     gradients and d_x within 1e-5; K7 launched once and K3 8 times; then
     the tool's four timings in a second run;
 12. row_gather probe: K8 (row_gather) bit-exact against its plain version
     on the probe's tables (442,368 rows of W = 128 and 256 bf16, N =
     1,048,576 random rows), a W = 128 f32 table, and a ragged N =
     1,000,003 with indices out of range; the in-range cases timed beside
     their bound and index_select; then
     cednerf_torch.tools.profile_row_gather.run at its defaults, counted:
     every `match` true and K8 launched by every setting.
  7b. scanned training: Trainer.run(SCANNED_STEPS) on the full-width
     field through run_chunk (BallCloudScene's device sampler, 16 steps a
     chunk, occupancy updates inside the chunks, the shrink-from-full
     lattice adaptation), a rolling checkpoint every 256 steps: finite
     losses, the last chunk's PSNR above the first's, K6 and K4 launched
     once a step and K5 once a step plus the occupancy probes, nothing else
     and no plain version; the empty-space-skip lattice on the card for 2
     chunks or more (by the shrink, else pinned at 512 slots for 2 chunks
     from the step-256 checkpoint); one skip-lattice chunk dispatched under
     torch.cuda.set_sync_debug_mode("error") and one run_chunk with exactly
     one host sync; a fresh Trainer resumed from the step-256 checkpoint
     (step, bucket and lattice restored, its first chunk the run's own
     chunk from there bit for bit); 2 chunks of march_seg=8 (K4 twice
     a step) and 2 of stacked host batches, finite; K4's result on the
     first lattice of each shape and budget these runs handed it (march_seg's
     [R, 128] segments and [49152, 8] samples among them) bit-exact against
     its plain version. Phase 6 also holds the steady-state steps (skip
     lattice, s_cap, march_seg) card vs CPU.
 13. hypernerf: the HyperNeRF preset (hypernerf_config, -te -ta -f -ae -df
     -d: L8 F4, max resolution 4096, 2^21 hashmap, field AABB +-2, cone
     angle 4e-3, 2 grid levels, alpha_thre 1e-2, near plane 0.2). A 32x32
     frame of a shrunken config through the lattice marcher on the card and
     on the CPU (budgeted and budgeted=False, phase 4's limits) and its
     train step card vs CPU (packed and packed_render=False, phase 6's
     limits); then at full width: K5 and K6 against their plain versions
     on the full-width field's levels (levels 0-1 dense, 2-7 hashed) at
     the step's 262,144 samples and a ragged 100,003 (phase 1's and 2's
     limits), one all-cells update of the 2-level grid, Trainer.run(HYPER_STEPS) over MonocularOrbitScene's device
     sampler (finite losses, rising PSNR, K5/K6/K4 at the counts the steps
     and probes imply, nothing else), ViewerServer /render of 400x400
     frames at max_samples 64, 128 and 256 through the lattice marcher (K4
     and K5 once a pass), PSNR / SSIM / MS-SSIM of a held-out view, and
     K4 bit-exact on every lattice shape these runs handed it.
 14. train_real: the real-data entry point `python -m
     cednerf_torch.train_real` on scenes written to a temporary directory
     in the datasets' own formats: a D-NeRF scene in lego's layout
     (800x800 RGBA, 50 train and 4 test frames of the procedural ball,
     rows cycling through PNG filters 0-4, so the C++ unfilter decodes
     them), its decode time; the full-width D-NeRF preset (-te -ta -f -ae
     -df -d) trained 1024 steps by a subprocess of the CLI (K5, K6 and K4
     launched, no plain version on CUDA, finite outputs, the test views'
     mean PSNR at least 3 dB above an all-white prediction's), a steady
     step's device ms (run_step, not run_chunk); a --load_model run that
     loads without evaluating (as the JAX CLI), then the loaded checkpoint
     evaluated in this process by train_real.evaluate_checkpoint (the
     train branch's evaluation) to the same PSNR within 1e-4 dB; a
     100x100 scene trained
     80 steps and its 120 video frames; K5 and K6 against their plain
     versions on the full-width DyNeRF field's level layout (outer +-8
     aabb, max resolution 8192) at its 2^20-sample budget and a ragged
     100,003; the HyperNeRF and DyNeRF presets, 80 steps each from vrig
     and images_x4 fixtures (DyNeRF: ISG weights by the native C++,
     --isg2ist_step 32, --mark_invisible), with their launches; K4
     bit-exact on every lattice shape the in-process runs handed it.
 15. secondary: the secondary encoders and row layouts at the full width
     of dnerf_config (secondary_phase): row_layout "cell" with
     fine_table_rows 65536 (K5 and K6c against their plain versions, K6c
     also for "cellz" and "cellfused"; fold_cells bit-equal to its plain
     version, K6c + fold against the plain pair, the resident cell
     buffers zero after every backward; K6c, the fold, the path they
     replaced and K6 timed at 262,144 uniform and ray-major and 1,048,576
     samples; the reference steps card vs CPU, 3D and hash4d, through the
     fold kernel;
     Trainer.run past the warmup on TexturedCloudScene's device sampler,
     K6c and fold_cells once a step, a chunk's device ms and the touched
     share of the cell levels' brick rows), hash4motion (K5 and K6 on the
     motion grid's F = 2 levels, a short run), --grid_type triplane and
     encoder_impl "gather"
     (a reference step and a short run each; the tri-plane step also in
     bf16 three ways, all modules, the encoder alone and the MLPs alone,
     the first held to TRIPLANE_BF16_GRAD_REL; a tri-plane frame of full
     seg passes and its peak memory) and remat_feats (bit-identical
     gradients on the K5/K6 and K1/K2 routes).
 16. proposal: the proposal path (engine/train_prop.py) at the full width
     of dnerf_config with -te -ta -f (proposal_phase): K5 and K6 against
     their plain versions at the proposal fields' layouts (L5 F2, 2^17:
     16 -> 128 at 1,048,576 points, 16 -> 256 at 2,097,152, uniform and
     contracted inputs), one prop step card vs CPU (phase 6's limits),
     PropTrainer on TexturedCloudScene (8,192 rays, 256 steps in 16-step
     chunks: finite losses, rising PSNR, K6 once a step per field and
     proposal field and nothing but K5 and K6, one chunk under
     set_sync_debug_mode("error") and one with exactly one host sync,
     device ms a step), an eval frame with occupancy culling and the same
     frame from a reloaded prop checkpoint (within 1e-4 dB), the HyperNeRF
     family's two unbounded nets for 64 steps, and `python -m
     cednerf_torch.train_prop_real` from disk, then --load_model
     --render_video.
 17. data parallelism (parallel/mesh.py, dp_phase): blocked K4 (one
     launch for cfg.compact_blocks > 1) bit-exact against its plain
     version for 2, 4 and 8 blocks on a [16000, 1024] lattice at ~10% and
     on a ragged [3000, 333] one with an empty and an overflowing block,
     timed beside its bound and torch.nonzero; a full-width Trainer chunk
     with compact_blocks 2 (blocked K4 once a step, counted); two ranks
     sharing the card over gloo (subprocesses of this script, --dp_rank):
     bit-equal to each other and at phase 6's limits against that chunk,
     and run a second time from the same seed: each rank's parameters,
     occupancy grid, Adam state and chunk_log bit-equal to its first run; a
     one-rank NCCL mesh's Trainer against the mesh-free one (bit for
     bit), its chunk free of host syncs; a render_image(mesh=...) frame; a
     PropTrainer(mesh=...) chunk (bit for bit against the mesh-free one);
     and `python -m torch.distributed.run
     --standalone --nproc_per_node 1 -m cednerf_torch.train_real --dp` on
     a 100x100 scene.
 18. reproducibility (repro_phase): the table-gradient kernels K6, K6c
     (with its fold), K2 and K3 launched three times on the same inputs at
     the train step's 262,144 samples (uniform, ray-major, all in one
     level-0 brick; K3 on 4D corner entries): bit-equal, and bit-equal to
     a launch with torch.sort's permutation in place of key_sort's,
     within phases 3, 8 and 15's limits against their plain versions,
     timed beside their bounds (the function's own bytes; `algo_bound_ms`
     adds this design's own traffic: the keys, the sort's passes, the
     sorted keys and index); the ordered reduce (its carry folded in, its
     rows of crossing runs held to carry_plain) and the sort, each alone
     (key_sort and torch.sort), and the ordered reduce's library
     yardstick (torch.segment_reduce over the sorted corner terms), and
     the strict-order chain (one tile) on the one-brick input's level 0;
     two Trainers from one seed at full width: the 3D path (-te -ta -f
     -ae -df -d on BallCloudScene, 32 run_step steps then 16-step chunks
     to 288), hash4d, row_layout cell with fine_table_rows 65536 and the
     tri-plane encoder (4 chunks each) and a PropTrainer (2 chunks), each
     pair bit-equal in every parameter, occupancy grid, optimizer state,
     chunk_log and metric; one step of each path under
     torch.use_deterministic_algorithms(True, warn_only=True) in a
     process with CUBLAS_WORKSPACE_CONFIG=:4096:8 (audit_main): its
     flagged ops printed as one JSON line, each with its reason, and no
     float scan of a one-row tensor; phase 14's lego command twice at its
     default seed (once more, beside the audit, against phase 14's run):
     equal chunk logs and eval PSNRs.
Phases 5, 7, 7b, 10, 13, 14, 15, 16 and 17 fail if K7 or K8 launched on a
serving or training path. Phase 14 prints the lego run's per-chunk log
(Trainer.chunk_log: loss, PSNR, complete_frac, bucket, steady lattice,
occupied share, non-finite steps) when its PSNR check fails.

`python3 chip_smoke.py --lego_runs N [--lego_parallel P]` runs only phase
14's lego command N times at its default seed, P at once, and writes each
run's PSNR and per-chunk log to --lego_out (lego_runs);
`--lego_seeds 0-23 [--lego_repeats 2]` runs it for each seed of the list,
twice each: per seed the PSNRs, whether its runs agree bit for bit (exit
3 if one does not) and whether it collapsed (exit 2), with the first chunk
out of band of a seed that did.
`python3 chip_smoke.py --sort_ab DIR [--sort_ab DIR2 ...]` runs only
phase 8b's key sets, this tree's key_sort and the one built from each
checkout DIR (the parent commit unpacked by `git archive` into `.ab/`,
say) in turns, each held to torch.sort's permutation (sort_ab_main).

Prints one JSON line per check, then the `kernels` line, then as its last
line {"ok": true, "device": {...}}.
"""

import argparse
import concurrent.futures
import contextlib
import dataclasses
import http.client
import json
import os
import sys
import time

# bf16 output of a kernel vs the plain version's f32 sum: one bf16 rounding
# (half an ulp, <= 2^-8 relative) plus f32 summation order (~1e-11 absolute
# at the +-1e-4 table scale)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-9
F32_RTOL, F32_ATOL = 1e-5, 1e-9
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM, f32 outside the tensor cores
REF_TABLE_BOUND = 8.0          # hash tables of the reference phase's fields
# K6/K2 against their plain versions: the table gradient is summed in two
# levels (tiles of 256 sorted terms, then the tiles in order) where the
# plain index_add adds in one (up to ~1,200 adds per address on the coarse
# dense level at 262,144 samples), so each level's table gradient is held
# to 1e-4 of that level's largest entry; d_x is summed in a fixed order on
# both sides, 1e-5 of its largest entry.
BWD_TABLE_FRAC, BWD_DX_FRAC = 1e-4, 1e-5
# the reference step's shrunken config (tests/test_torch_train.py's)
SMALL = dict(target_sample_batch_size=4096, grid_resolution=16,
             render_step_size=2e-2, max_march_steps=128,
             hash_dst_resolution=128, log2_hashmap_size=14,
             max_table_rows=512, hash_n_levels=4,
             grad_accum_dtype="float32")
# reference step, card vs CPU: each parameter's gradient L2 error relative
# to its norm, and the loss's relative error. The sound readings on an H100
# are 0.0034 (motion MLP, where cuBLAS's and the CPU's bf16 GEMMs round
# differently) and 2.4e-6; on the CPU, one level's position gradient
# scaled by 1.02 reads 0.0094 and by 1.05 0.0184, one dropped table-gradient
# corner 0.31, and one level's features scaled by 1.01 move the loss 7.4e-4.
STEP_GRAD_REL, STEP_LOSS_RTOL = 0.01, 1e-4
# the training phase: 288 default-route steps (the 256-step all-cells
# occupancy warmup, then 32 steps with sampled updates; the scanned phase
# trains the steady state longer), then 8 on the K1/K2 route
TRAIN_STEPS, INTERP_STEPS = 288, 8
# the hash4d training phase: the 256-step warmup and 64 steps after it
HASH4D_STEPS = 320
# the scanned training phase: Trainer.run(512) at 16 steps a chunk (runs
# while step <= 512, so 33 chunks), a checkpoint every 256 steps; the
# empty-space-skip lattice pinned for 2 chunks if the shrink did not fire
SCANNED_STEPS, SCANNED_K, SCANNED_CKPT = 512, 16, 256
PINNED_LATTICE = 512
# the HyperNeRF phase: Trainer.run(HYPER_STEPS) at HYPER_K steps a chunk
# (the 256-step warmup and 64 after it; runs while step <= 320, so 21
# chunks), then 400x400 frames at these max_samples
HYPER_STEPS, HYPER_K = 320, 16
HYPER_SAMPLES = (64, 128, 256)
# its card-vs-CPU frame and steps: the shrunken config of the reference
# step (SMALL) on the HyperNeRF preset (cone, 2 levels, alpha_thre, near
# 0.2) with a 1e-2 step, whose 384 cone steps cross the +-2 box
HYPER_REF = dict(SMALL, render_step_size=1e-2, max_march_steps=384)
# K3 against its plain version: both sum in f32, K3 in the ordered
# reduce's two levels, index_add_ in one (up to ~1,200 adds per address on
# level 0 at 262,144 samples), so each table is held to 1e-4 of its largest
# entry, as K6's table gradient.
K3_FRAC = 1e-4
# K7 against its plain version: its update rows are the plain version's f32
# products in the same order, d_x the same sums in another order; held to
# the limits of K6/K2: 1e-4 of each level's largest upd entry, 1e-5 of d_x's
K7_UPD_FRAC, K7_DX_FRAC = BWD_TABLE_FRAC, BWD_DX_FRAC
# the tri-plane reference step in bf16 (phase 15), card vs CPU: its worst
# gradient's error relative to its norm (triplane_bf16_steps). On an H100
# the all-bf16 step reads 1.70% (motion_mlp.out.bias, the first module of
# the chain, whose gradient every later bf16 rounding reaches), the
# encoder alone in bf16 1.50% and the MLPs alone 2.38%: each half's bf16
# roundings alone move it 1.5-2.4%, so neither carries the reading and the
# 1% of phase 6 (set on hash3d, whose 16 encoder features feed mlp_base
# where the tri-plane's 128 do) does not apply. 3% holds the sound
# readings; a dropped table-gradient corner reads ~31% (phase 6's note).
TRIPLANE_BF16_GRAD_REL = 0.03
# kernels that only the probe paths (phases 11 and 12) run
PROBE_KERNELS = ("interp_bwd", "row_gather")


def log(msg):
    print(msg, flush=True)


def no_probe_kernels(label, launches):
    """Fails if K7 or K8 launched on a serving or training path."""
    ran = {k: launches[k] for k in PROBE_KERNELS if launches[k]}
    if ran:
        raise AssertionError(f"{label} launched a probe kernel: {ran}")


def reset_counts():
    from cednerf_torch.utils.bench import reset_kernel_counts
    reset_kernel_counts()


def all_counts():
    """(launches, plain-version calls on CUDA) of every kernel wrapper."""
    from cednerf_torch.utils.bench import kernel_counts
    return kernel_counts()


def check_close(name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    bad = err > rtol * want.float().abs() + atol
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} values outside "
                             f"rtol {rtol} atol {atol}; max err "
                             f"{err.max().item()}")
    return err.max().item()


def _level_rows(x, spec):
    """[L, N] int32 brick rows of x on every level of `spec`."""
    import torch
    from cednerf_torch.ops.brick_grid import _level_geom

    lay = spec.level_layout()
    return torch.stack([
        _level_geom(x, s, l["n_bricks_axis"], l["hashed"], l["rows"])[0]
        for s, l in zip(spec.level_scales(), lay)]).contiguous()


def _ray_major_x(n_rays, seed):
    import torch
    from cednerf_torch.utils.bench import ray_major_samples
    return torch.from_numpy(ray_major_samples(n_rays, 64, seed)[0]).cuda()


def _draw_x(n, gen, inner):
    """n positions uniform over the unit cube (the field's whole aabb);
    with `inner` = (lo, hi), every other one uniform over [lo, hi)^3
    instead (where a preset with outer grid levels puts its scene)."""
    import torch
    x = torch.rand((n, 3), device="cuda", generator=gen)
    if inner is not None:
        lo, hi = inner
        x[1::2] = lo + x[1::2] * (hi - lo)
    return x


def kernel_phase(field, n_main, n_ragged, seed,
                 names=("fused_encode_fwd", "interp_fwd"), timed=True,
                 inner=None, encoder=None, draw=None):
    """K5 and K1 against their plain versions on the field's levels and its
    tables (those of `encoder`, the field's hash_encoder by default), x
    uniform over the unit cube (and half of it over `inner`, see _draw_x;
    or draw(n, generator)), at n_main and at a ragged count; with `timed`,
    each timed at n_main. `names` picks the kernels."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops.brick_grid import level_tables
    from cednerf_torch.utils.bench import cuda_ms

    encoder = encoder or field.hash_encoder
    spec = encoder.bspec
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    L, F = spec.n_levels, spec.n_features
    with torch.no_grad():
        tables = [t.to(torch.bfloat16) for t in
                  level_tables(encoder.tables(), spec)]
    table = torch.cat(tables).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    results = {}
    for n in (n_main, n_ragged):
        x = draw(n, gen) if draw else _draw_x(n, gen, inner)
        rows = _level_rows(x, spec)
        feats = (torch.stack([tables[l].index_select(0, rows[l].long())
                              for l in range(L)]).contiguous()
                 if "interp_fwd" in names else None)
        calls = {
            "fused_encode_fwd": (
                lambda od: ek.fused_encode_fwd(x, table, rows, scales, nbs,
                                               level_rows, F, od),
                lambda: ek.fused_encode_fwd_plain(x, table, rows, scales, nbs,
                                                  level_rows, F,
                                                  torch.float32)),
            "interp_fwd": (
                lambda od: ek.interp_fwd(x, feats, scales, nbs, F, od),
                lambda: ek.interp_fwd_plain(x, feats, scales, nbs, F,
                                            torch.float32)),
        }
        for name in names:
            kern, plain = calls[name]
            want = plain()
            got16 = kern(torch.bfloat16)
            got32 = kern(torch.float32)
            torch.cuda.synchronize()
            err16 = check_close(f"{name} N={n} bf16", got16, want,
                                BF16_RTOL, BF16_ATOL)
            err32 = check_close(f"{name} N={n} f32", got32, want,
                                F32_RTOL, F32_ATOL)
            rec = {"name": name, "n": n, "levels": L, "n_feat": F,
                   "max_abs_err": err16, "max_abs_err_f32_out": err32}
            if n == n_main:
                results[name] = rec
            if n == n_main and timed:
                rec["ms"] = cuda_ms(lambda: kern(torch.bfloat16), 20)
                rec["plain_ms"] = cuda_ms(plain, 3)
                out_b = n * L * F * 2
                if name == "fused_encode_fwd":
                    in_b = rows.numel() * 4 + x.numel() * 4 \
                        + table.numel() * 2
                    # the corner sectors that K5 reads, with the rows, x and
                    # the output, at the HBM rate
                    rec["sector_bound_ms"] = (
                        in_b - table.numel() * 2 + _corner_bytes(n, L, F)
                        + out_b) / HBM_BYTES_PER_S * 1e3
                    xm = _ray_major_x(n // 64, seed)
                    rm = _level_rows(xm, spec)
                    rec["ray_major_ms"] = cuda_ms(
                        lambda: ek.fused_encode_fwd(
                            xm, table, rm, scales, nbs, level_rows, F), 20)
                    del xm, rm
                else:
                    in_b = x.numel() * 4 + _corner_bytes(n, L, F)
                t_bytes = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
                # the interpolation needs 8 corners x F multiply-adds per
                # (sample, level)
                t_ops = n * L * 8 * F * 2 / F32_FLOPS * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                rec["row_bytes"] = n * L * 64 * F * 2
            log(json.dumps({"kernel_check": rec}))
        del feats
        torch.cuda.empty_cache()
    return results


def cell_kernel_phase(spec4, seed):
    """K5, K1 and K6 against their plain versions on the points that stress
    their corner addressing: every intra cell of a few bricks and cell and
    brick boundaries (with their f32 neighbours) on each level
    (bench.cell_points), then 10,007 uniform points, at the field's level
    geometry with F = 1, 2 and 4, tables of +-1e-4 as a fresh field's; K5
    and K1 (on the rows gathered at those points) in both output dtypes.
    Then K6 on 262,144 samples that all lie in one
    level-0 brick, tables of +-8 (every term of level 0 on one row: one
    key across ~1,000 reduce tiles, through the folded carry), timed."""
    import numpy as np
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.utils.bench import cell_points, cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    recs = []
    for F in (1, 2, 4):
        spec = dataclasses.replace(spec4, n_features=F)
        lay = spec.level_layout()
        scales = spec.level_scales()
        nbs = [l["n_bricks_axis"] for l in lay]
        level_rows = [l["rows"] for l in lay]
        L = spec.n_levels
        x = torch.cat([torch.from_numpy(cell_points(scales, nbs, seed)).cuda(),
                       torch.rand((10_007, 3), device="cuda", generator=gen)])
        rows = _level_rows(x, spec)
        table = ((torch.rand((sum(level_rows), 64 * F), device="cuda",
                             generator=gen) * 2 - 1) * 1e-4).to(torch.bfloat16)
        want = ek.fused_encode_fwd_plain(x, table, rows, scales, nbs,
                                         level_rows, F, torch.float32)
        rec = {"case": "cells", "n": x.shape[0], "levels": L, "n_feat": F}
        for od, rtol, atol in ((torch.bfloat16, BF16_RTOL, BF16_ATOL),
                               (torch.float32, F32_RTOL, F32_ATOL)):
            got = ek.fused_encode_fwd(x, table, rows, scales, nbs,
                                      level_rows, F, od)
            torch.cuda.synchronize()
            rec[f"k5_max_abs_err_{str(od)[6:]}"] = check_close(
                f"fused_encode_fwd cells F={F} {od}", got, want, rtol, atol)
        offs = np.cumsum([0] + level_rows)
        feats = torch.stack([table[offs[l]:offs[l + 1]].index_select(
            0, rows[l].long()) for l in range(L)]).contiguous()
        want1 = ek.interp_fwd_plain(x, feats, scales, nbs, F, torch.float32)
        for od, rtol, atol in ((torch.bfloat16, BF16_RTOL, BF16_ATOL),
                               (torch.float32, F32_RTOL, F32_ATOL)):
            got = ek.interp_fwd(x, feats, scales, nbs, F, od)
            torch.cuda.synchronize()
            rec[f"k1_max_abs_err_{str(od)[6:]}"] = check_close(
                f"interp_fwd cells F={F} {od}", got, want1, rtol, atol)
        del feats
        g = torch.randn((x.shape[0], L * F), device="cuda",
                        generator=gen).to(torch.bfloat16)
        g[::8] = 0
        rec.update(_k6_against_plain(f"cells F={F}", x, g, rows, table,
                                     scales, nbs, level_rows, F))
        log(json.dumps({"kernel_check": {"name": "k5_k1_k6_cells", **rec}}))
        recs.append(rec)
    spec = spec4
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    L, F, n = spec.n_levels, spec.n_features, 262_144
    # pos = x * scale + 0.5 in [3.01, 5.99) on every axis: level-0 brick 1
    x = ((torch.rand((n, 3), device="cuda", generator=gen) * 2.98 + 2.51)
         / float(np.float32(scales[0])))
    rows = _level_rows(x, spec)
    table = ((torch.rand((sum(level_rows), 64 * F), device="cuda",
                         generator=gen) * 2 - 1) * REF_TABLE_BOUND
             ).to(torch.bfloat16)
    g = (torch.randn((n, L * F), device="cuda", generator=gen) * 1e-3
         ).to(torch.bfloat16)
    rec = {"case": "one level-0 brick", "n": n, "levels": L, "n_feat": F,
           "level0_rows": int(torch.unique(rows[0]).numel())}
    rec.update(_k6_against_plain("one brick", x, g, rows, table, scales, nbs,
                                 level_rows, F))
    rec["ms"] = cuda_ms(lambda: ek.fused_encode_bwd(
        x, g, rows, table, scales, nbs, level_rows, F), 20)
    log(json.dumps({"kernel_check": {"name": "fused_encode_bwd", **rec}}))
    recs.append(rec)
    torch.cuda.empty_cache()
    return recs


def _bwd_errors(label, got, want, level_rows):
    """(each level's table-gradient error as a fraction of that level's
    largest entry, d_x's error as a fraction of its largest entry) of
    got = (d_table, d_x) against want; fails above BWD_TABLE_FRAC or
    BWD_DX_FRAC."""
    offs = [0]
    for r in level_rows:
        offs.append(offs[-1] + r)
    errs = [_frac_err(got[0][offs[l]:offs[l + 1]],
                      want[0][offs[l]:offs[l + 1]])
            for l in range(len(level_rows))]
    err_x = _frac_err(got[1], want[1])
    if max(errs) > BWD_TABLE_FRAC or err_x > BWD_DX_FRAC:
        raise AssertionError(
            f"{label}: table errors per level {errs} (limit "
            f"{BWD_TABLE_FRAC}), d_x {err_x} (limit {BWD_DX_FRAC})")
    return errs, err_x


def _k6_against_plain(label, x, g, rows, table, scales, nbs, level_rows, F):
    """K6 against its plain version (_bwd_errors' limits)."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek

    want = ek.fused_encode_bwd_plain(x, g, rows, table, scales, nbs,
                                     level_rows, F)
    got = ek.fused_encode_bwd(x, g, rows, table, scales, nbs, level_rows, F)
    torch.cuda.synchronize()
    errs, err_x = _bwd_errors(f"fused_encode_bwd {label}", got, want,
                              level_rows)
    return {"k6_table_err_frac": max(errs), "k6_dx_err_frac": err_x}


def reference_phase(field, occ, cfg, flags, seed):
    """The served route on the card against the plain route on the CPU,
    from fields built from `seed` and given the same
    uniform(-REF_TABLE_BOUND, REF_TABLE_BOUND) hash tables.

    1. encoder: the field's hash encoder (brick_encode: row geometry, dense
       bricks, table prep and the K5 launch) on random points and on points
       that sit on cell boundaries of every level;
    2. frame: a 32x32 frame. The served `field` keeps its initial +-1e-4
       tables, so its features are ~0, as an encoder that returned zeros
       would give; its frame must differ from the card's reference frame by
       far more than the tolerance, which shows that the check can fail.
       At the initial scale, or at +-2, the full-width density MLP damps
       the features so far that the frame barely moves (on the CPU, +-4
       moved rgb by 0.06 at most); at +-8 it moves rgb by ~0.3.

    Tolerances. Encoder (bf16 out): rtol 2^-7 (one bf16 rounding) and atol
    1e-4 (the f32 sums of 8 products of up to 8 in another order). Frame:
    rgb and opacity 2e-2 absolute; depth 5e-2 (scene units, the camera is 4
    away) on rays of opacity >= 0.1, where depth is not the rounding noise
    of a near-transparent ray. Why any: the card's and the CPU's bf16 GEMMs
    round differently, and a ray at the early-stop threshold can stop one
    pass earlier on one side."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.rays import pinhole_rays
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.renderer import make_eval_render_fn, render_image
    from cednerf_torch.ops.occupancy import OccGridState
    from cednerf_torch.utils.bench import load_uniform_tables, orbit_c2w

    card = next(field.parameters()).device
    ref_fields = [build_field(cfg, flags, device=dev, seed=seed)
                  for dev in (card, "cpu")]
    load_uniform_tables(ref_fields, seed, REF_TABLE_BOUND)
    rec = {}

    # 1. the encoder on the served route
    gen = torch.Generator().manual_seed(seed)
    pts = [torch.rand((65536, 3), generator=gen) * 1.1 - 0.05]
    for scale in ref_fields[1].hash_encoder.bspec.level_scales():
        k = torch.randint(0, int(scale) + 2, (4096, 3), generator=gen)
        pts.append(((k.double() - 0.5) / float(np.float32(scale))).float())
    xe = torch.cat(pts)
    with torch.inference_mode():
        got = ref_fields[0].hash_encoder(xe.to(card)).float().cpu()
        want = ref_fields[1].hash_encoder(xe).float()
    rec["encoder_max_abs_err"] = check_close(
        "reference encoder", got, want, 2.0 ** -7, 1e-4)
    rec["encoder_max_abs"] = want.abs().max().item()

    # 2. a frame
    w = 32
    K = np.array([[w * 1.1, 0, w / 2], [0, w * 1.1, w / 2], [0, 0, 1]],
                 np.float32)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="xy")
    o, d, _ = pinhole_rays(xx.reshape(-1), yy.reshape(-1), K,
                           np.broadcast_to(orbit_c2w(), (w * w, 3, 4)), True)
    bkgd = np.ones(3, np.float32)
    ref_occ = OccGridState(*(a.cpu() for a in occ))
    outs = []
    for f, g in ((ref_fields[0], occ), (ref_fields[1], ref_occ),
                 (field, occ)):
        fn = make_eval_render_fn(f, cfg, s_max=64)
        outs.append(render_image(f, g, fn, o, d, 0.5, bkgd, chunk=4096))
    rec.update(_compare_frames("reference", *outs))
    return rec


def _compare_frames(label, card_out, ref_out, served_out):
    """The frame checks of reference_phase: the card's (rgb, opacity,
    depth) against the CPU's, rgb and opacity within 2e-2, depth within
    5e-2 on rays of opacity >= 0.1, all finite; and the served frame of a
    field with ~0 features must differ from the card's by more than 5x the
    rgb and opacity limits, which shows that the check can fail."""
    import numpy as np

    seen = ref_out[1][..., 0] >= 0.1
    rec = {"opacity_mean": float(ref_out[1].mean()),
           "depth_rays": int(seen.sum())}
    for i, (name, tol) in enumerate((("rgb", 2e-2), ("opacity", 2e-2),
                                     ("depth", 5e-2))):
        a, b, z = card_out[i], ref_out[i], served_out[i]
        if not (np.isfinite(a).all() and np.isfinite(z).all()):
            raise AssertionError(f"{label}: non-finite {name} on the card")
        if name == "depth":
            a, b, z = a[seen], b[seen], z[seen]
        err = float(np.abs(a - b).max())
        if err > tol:
            raise AssertionError(f"{label}: {name} differs by {err} "
                                 f"(> {tol}): {rec}")
        rec[f"{name}_max_abs_err"] = err
        rec[f"{name}_moved_by_zero_features"] = float(np.abs(z - a).max())
        if name != "depth" and rec[f"{name}_moved_by_zero_features"] < 5 * tol:
            raise AssertionError(
                f"{label}: zero features barely move {name}, so the frame "
                f"check could not fail: {rec}")
    return rec


def post_render(port, c2w, t, width, max_samples, depth):
    from cednerf_torch.utils.image import decode_png
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = json.dumps({"c2w": c2w.reshape(-1).tolist(), "time": t,
                           "width": width, "max_samples": max_samples,
                           "depth": depth})
        t0 = time.perf_counter()
        conn.request("POST", "/render", body=body)
        resp = conn.getresponse()
        data = resp.read()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()
    if resp.status != 200 or resp.getheader("Content-Type") != "image/png":
        raise AssertionError(f"/render: status {resp.status}, "
                             f"type {resp.getheader('Content-Type')}")
    img = decode_png(data)
    if img.shape != (width, width, 3):
        raise AssertionError(f"/render: image {img.shape}")
    return img, wall_ms, len(data)


def serving_phase(field, field_k1, occ, cfg):
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.utils.bench import orbit_c2w
    from cednerf_torch.viewer.server import ViewerServer

    c2w = orbit_c2w()
    servers = [ViewerServer(f, occ, cfg, wh=(400, 400), render_bkgd=(1, 1, 1))
               for f in (field, field_k1)]
    httpds = [s.start(port=0, host="127.0.0.1") for s in servers]
    ports = [h.server_address[1] for h in httpds]
    requests = [(0, 0.0, 400, 128, False), (0, 0.5, 400, 128, True),
                (0, 1.0, 400, 128, False), (0, 0.5, 800, 256, False),
                (1, 0.5, 400, 128, False)]
    frames = []
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ports[0], timeout=60)
        conn.request("GET", "/")
        page = conn.getresponse().read()
        conn.request("GET", "/snap")
        snap = json.loads(conn.getresponse().read())
        conn.close()
        if b"cednerf_torch viewer" not in page or "radius" not in snap:
            raise AssertionError("viewer page or /snap malformed")
        # warm-up frame outside the counted run (allocator, cuBLAS handles)
        post_render(ports[0], c2w, 0.25, 64, 32, False)
        reset_counts()
        for which, t, width, ms, depth in requests:
            before = dict(ek.launches)
            _, wall_ms, n_bytes = post_render(ports[which], c2w, t, width,
                                              ms, depth)
            stats = servers[which].last_frame
            if not stats["finite"]:
                raise AssertionError(f"non-finite frame {width}/{ms} t={t}")
            rec = {"route": "K5" if which == 0 else "K1", "t": t,
                   "width": width, "max_samples": ms, "depth": depth,
                   "render_ms": stats["ms"], "http_ms": wall_ms,
                   "png_bytes": n_bytes,
                   "launches": {k: v - before[k]
                                for k, v in ek.launches.items()},
                   "chunks": len(stats["passes_per_chunk"]),
                   "passes_per_chunk": stats["passes_per_chunk"]}
            frames.append(rec)
            log(json.dumps({"frame": rec}))
        launches, plain = all_counts()
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()
    if launches["fused_encode_fwd"] == 0 or launches["interp_fwd"] == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if launches["scatter_add_rows"]:
        raise AssertionError(f"serving launched K3: {launches}")
    no_probe_kernels("serving", launches)
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on CUDA: {plain}")
    return frames, launches


def _corner_bytes(n, L, F):
    """The bytes of brick rows that K1 and K2 must read, and that K5 and K6
    do read: the 8 corners of a (sample, level) lie on 4 z-lines of the 4^3
    brick, each 4 corners x F bf16 (8F bytes, one 32-byte DRAM sector at
    F = 4), and the other 56 corners of the 64F row are never read."""
    return n * L * 4 * 8 * F


def _frac_err(got, want):
    """max |got - want| / max |want|."""
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / max(scale, 1e-30)


def backward_kernel_phase(field, n_main, n_ragged, seed,
                          names=("fused_encode_bwd", "interp_bwd_fused"),
                          timed=True, inner=None, encoder=None, draw=None):
    """K6 and K2 (one kernel body, on the table and on the gathered rows)
    against their plain versions on the full-width field's levels (those of
    `encoder`, the field's hash_encoder by default), tables uniform(-8, 8),
    x as kernel_phase draws it (`inner`, `draw`), at one train step's
    sample count and at a ragged one;
    with `timed`, each timed at the step's count on uniform random and on
    ray-major samples. One bf16 cotangent row in eight is zero (unused
    budget slots carry zero). `names` picks the kernels."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.utils.bench import cuda_ms

    spec = (encoder or field.hash_encoder).bspec
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    L, F = spec.n_levels, spec.n_features
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = ((torch.rand((sum(level_rows), 64 * F), device="cuda",
                         generator=gen) * 2 - 1) * REF_TABLE_BOUND
             ).to(torch.bfloat16)
    offs = [0]
    for r in level_rows:
        offs.append(offs[-1] + r)

    def gather(rows):
        """The rows [L, N, 64F] that the K1 forward saves for K2."""
        return torch.stack([table[offs[l]:offs[l + 1]].index_select(
            0, rows[l].long()) for l in range(L)]).contiguous()

    results = {}
    for n in (n_main, n_ragged):
        x = draw(n, gen) if draw else _draw_x(n, gen, inner)
        g = (torch.randn((n, L * F), device="cuda", generator=gen) * 1e-3
             ).to(torch.bfloat16)
        g[::8] = 0
        rows = _level_rows(x, spec)
        feats = gather(rows) if "interp_bwd_fused" in names else None
        want_t, want_x = ek.fused_encode_bwd_plain(x, g, rows, table, scales,
                                                   nbs, level_rows, F)
        calls = {
            "fused_encode_bwd": (
                lambda: ek.fused_encode_bwd(x, g, rows, table, scales, nbs,
                                            level_rows, F),
                lambda: ek.fused_encode_bwd_plain(x, g, rows, table, scales,
                                                  nbs, level_rows, F)),
            "interp_bwd_fused": (
                lambda: ek.interp_bwd_fused(x, g, feats, rows, scales, nbs,
                                            level_rows, F),
                lambda: ek.interp_bwd_fused_plain(x, g, feats, rows, scales,
                                                  nbs, level_rows, F)),
        }
        for name in names:
            kern, plain = calls[name]
            d_t, d_x = kern()
            torch.cuda.synchronize()
            errs, err_x = _bwd_errors(f"{name} N={n}", (d_t, d_x),
                                      (want_t, want_x), level_rows)
            rec = {"name": name, "n": n, "levels": L, "n_feat": F,
                   "max_abs_err": max((d_t - want_t).abs().max().item(),
                                      (d_x - want_x).abs().max().item()),
                   "table_err_frac_per_level": errs, "dx_err_frac": err_x,
                   "d_table_max": want_t.abs().max().item()}
            if n == n_main:
                results[name] = rec
            if n == n_main and timed:
                rec["ms"] = cuda_ms(kern, 20)
                rec["plain_ms"] = cuda_ms(plain, 3)
                src_b = (table.numel() * 2 if name == "fused_encode_bwd"
                         else _corner_bytes(n, L, F))
                in_b = x.numel() * 4 + g.numel() * 2 + rows.numel() * 4 \
                    + src_b
                out_b = want_t.numel() * 4 + want_x.numel() * 4
                t_bytes = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
                # per (sample, level): 8 corners x F multiply-adds for the
                # table gradient and F for the position gradient's dot
                t_ops = n * L * 8 * F * 2 * 2 / F32_FLOPS * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                # the ordered reduce's own traffic on top: its keys written,
                # sorted and read (not bytes the function needs)
                rec["algo_bound_ms"] = max(
                    t_bytes + _ordered_bytes(n * L, sum(level_rows))
                    / HBM_BYTES_PER_S * 1e3, t_ops)
                # the kernels' own traffic per (sample, level): the 4
                # z-lines the first reads (8F bytes each) and the sample's
                # x and g that the reduce reads again
                rec["corner_bytes"] = n * L * (4 * 8 * F + 12 + 2 * F)
                xm = _ray_major_x(n // 64, seed)
                rm = _level_rows(xm, spec)
                if name == "fused_encode_bwd":
                    rec["ray_major_ms"] = cuda_ms(
                        lambda: ek.fused_encode_bwd(
                            xm, g, rm, table, scales, nbs, level_rows, F), 20)
                else:
                    fm = gather(rm)
                    rec["ray_major_ms"] = cuda_ms(
                        lambda: ek.interp_bwd_fused(
                            xm, g, fm, rm, scales, nbs, level_rows, F), 20)
                    del fm
                del xm, rm
            log(json.dumps({"kernel_check": rec}))
        del feats, want_t, want_x
        torch.cuda.empty_cache()
    return results


def compact_kernel_phase(budget, seed):
    """K4 bit-exact against its plain version on the warmup and top ray
    buckets' lattices at occupancy 1.0 and ~0.1; times the top bucket at
    ~0.1 (a carved steady-state grid) beside torch.nonzero, each with CUDA
    events over 20 back-to-back calls (`ms`, `library_ms`) and by its
    device time per call under the profiler (`device_ms`,
    `library_device_ms`, with the kernels each call ran)."""
    import torch
    from cednerf_torch.ops import compact_kernels as ck
    from cednerf_torch.utils.bench import cuda_ms, device_ms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    main = None
    for rays in (256, 16000):
        for occ in (1.0, 0.1):
            valid = torch.rand((rays, 1024), device="cuda",
                               generator=gen) < occ
            sel, kept = ck.compact_select_kernel(valid, budget)
            want = ck.compact_select_rayfold(valid, budget)
            torch.cuda.synchronize()
            if not (torch.equal(sel, want[0]) and torch.equal(kept, want[1])):
                raise AssertionError(f"compact_select {rays}x1024 occ {occ}: "
                                     "differs from its plain version")
            rec = {"name": "compact_select", "lattice": [rays, 1024],
                   "occupancy": occ, "budget": budget, "max_abs_err": 0,
                   "n_valid": int(valid.sum().item()),
                   "n_selected": int(kept.sum().item())}
            if rays == 16000 and occ == 0.1:
                rec["ms"] = cuda_ms(
                    lambda: ck.compact_select_kernel(valid, budget), 20)
                rec["plain_ms"] = cuda_ms(
                    lambda: ck.compact_select_rayfold(valid, budget), 3)
                flat = valid.reshape(-1)
                rec["library_ms"] = cuda_ms(lambda: torch.nonzero(flat), 20)
                rec["device_ms"], k4_rows, rec["calls_seen"] = device_ms(
                    lambda: ck.compact_select_kernel(valid, budget), 20)
                rec["library_device_ms"], lib_rows, _ = device_ms(
                    lambda: torch.nonzero(flat), 20)
                rec["device_kernels"] = [r[:2] for r in k4_rows]
                rec["library_device_kernels"] = [r[:2] for r in lib_rows]
                n = valid.numel()
                # read the lattice once, write kept and sel once; the work
                # is a few integer operations per candidate
                t_bytes = (2 * n + 4 * budget) / HBM_BYTES_PER_S * 1e3
                t_ops = 4 * n / F32_FLOPS * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                main = rec
            log(json.dumps({"kernel_check": rec}))
    return main


def _as_rows(keys, terms, n_keys):
    """The corner entries of a 4D brick level (keys = keyframe row * 64 +
    corner, [2N*8] int32; terms [2N*8, F]) in the [2N, 64F] update-row
    form that the brick levels handed K3 before (a zero fill and the 8
    live corners of each row): (rows [2N] int32, upd [2N, 64F] f32,
    n_rows)."""
    import torch
    f = terms.shape[1]
    m = keys.numel() // 8
    upd = torch.zeros((m, 64, f), dtype=terms.dtype, device=terms.device)
    corner = (keys.long() % 64).view(m, 8)
    upd.scatter_(1, corner[:, :, None].expand(m, 8, f), terms.view(m, 8, f))
    return ((keys.view(m, 8)[:, 0] // 64).contiguous(), upd.view(m, 64 * f),
            n_keys // 64)


def _sort_bytes(m, n_keys):
    """The bytes key_sort moves on m keys (csrc/key_sort.cuh): the
    histogram reads the keys (4 B a key); the first pass reads them and
    writes (key, index) pairs, a pass between reads and writes pairs, the
    last reads pairs and writes the sorted keys and perm: 16 B a key a pass
    with the histogram's read (one pass: the keys read twice, keys and perm
    written); the status words, 4 B a tile a digit a pass, zeroed,
    published twice and read once."""
    from cednerf_torch.ops import scatter_kernels as sk
    _, passes, dbits = sk.sort_plan(n_keys)
    tiles = -(-m // sk.SORT_TILE_KEYS)
    return 16 * m * passes + 16 * passes * tiles * (1 << dbits)


def _ordered_bytes(m, n_keys, keys_written=True):
    """This design's own traffic in an ordered reduce of m keys, beyond the
    function's bytes: the keys the first kernel writes (keys_written; K3's
    are its input), the sort (_sort_bytes) and the sorted keys and index
    the reduce reads."""
    return (4 * m if keys_written else 0) + _sort_bytes(m, n_keys) + 8 * m


def _k3_inputs(cfg, seed, gen):
    """K3's inputs on the train paths, as its wrapper is handed them: the
    corner entries of level 0 and of the last hashed level from one
    backward of the full-width 4D field's encoder at the train step's N
    (positions and times uniform, a bf16 cotangent with one row in eight
    zero, as unused budget slots carry; the wrapper is wrapped for that one
    call to keep what it is handed), and the tri-plane encoder's texel
    gradient (W = F = 4 columns, K3's narrow rows) from one backward of the
    full-width encoder at the same N, drawn from `gen`. Returns (the 4D
    field's brick spec, [(label, n_rows, rows, upd)] for "level 0",
    "hashed level" and "tri-plane texels")."""
    import torch
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags
    from cednerf_torch.ops import scatter_kernels as sk
    from cednerf_torch.ops.triplane import TriPlaneSpec, triplane_encode
    from cednerf_torch.utils.bench import HASH4D_FLAGS

    field = build_field(cfg, ModelFlags(**HASH4D_FLAGS), device="cuda",
                        seed=seed)
    tspec = TriPlaneSpec(plane_res=cfg.hash_dst_resolution,
                         n_features=cfg.hash_n_features)
    spec = field.hash_encoder.bspec
    n = cfg.sample_budget
    xn = torch.rand((n, 3), device="cuda", generator=gen)
    t = torch.rand((n, 1), device="cuda", generator=gen)
    g = torch.randn((n, spec.output_dim), device="cuda",
                    generator=gen).to(torch.bfloat16)
    g[::8] = 0
    lay = spec.level_layout()
    cases = [("level 0", lay[0]["rows"] * spec.keyframes * 64),
             ("hashed level", lay[-1]["rows"] * spec.keyframes * 64),
             ("tri-plane texels", tspec.total_rows)]
    kept = {}
    real = sk.scatter_add_rows

    def keep(rows, upd, n_rows):
        if n_rows in {r for _, r in cases}:
            kept.setdefault(n_rows, (rows, upd))
        return real(rows, upd, n_rows)

    sk.scatter_add_rows = keep
    try:
        field.hash_encoder(xn, t).backward(g)
        planes = torch.empty((tspec.total_rows, tspec.n_features),
                             device="cuda").uniform_(-1e-4, 1e-4,
                                                     generator=gen)
        triplane_encode(xn, planes.requires_grad_(), tspec).backward(
            torch.randn((n, tspec.output_dim), device="cuda",
                        generator=gen).to(torch.bfloat16))
    finally:
        sk.scatter_add_rows = real
    del field, planes
    return spec, [(label, n_rows) + kept[n_rows] for label, n_rows in cases]


def _sort_key_sets(cases):
    """key_sort_phase's key sets from K3's cases (_k3_inputs): the hashed
    level's corner keys and the tri-plane's texel keys, {name: (keys,
    n_keys)}."""
    return {"hash4d corner keys": (cases[1][2], cases[1][1]),
            "tri-plane texels": (cases[-1][2], cases[-1][1])}


def scatter_kernel_phase(cfg, seed):
    """K3 against its plain version, on the cases of _k3_inputs. The hashed
    level also in the [2N, 64F] update-row form the 4D levels handed K3
    before (_as_rows: the same sums, 8x the bytes). Then a ragged M =
    100,003 of random rows of 256 lanes into the hashed level's table.
    Each timed beside its bound, its plain version and index_add_, with
    float atomics (`library_ms`) and under
    torch.use_deterministic_algorithms(True) (`library_det_ms`, the
    library form that gives the same bits on every run). Returns
    ({case: record}, _sort_key_sets of the cases, for key_sort_phase)."""
    import torch
    from cednerf_torch.ops import scatter_kernels as sk
    from cednerf_torch.utils.bench import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    spec, cases = _k3_inputs(cfg, seed, gen)
    real = sk.scatter_add_rows
    rows_f, upd_f, n_f = _as_rows(cases[1][2], cases[1][3], cases[1][1])
    cases.insert(2, ("hashed level, row form", n_f, rows_f, upd_f))
    m = 100_003
    cases.insert(3, ("ragged random rows", cases[2][1],
                     torch.randint(0, cases[2][1], (m,), device="cuda",
                                   generator=gen, dtype=torch.int32),
                     torch.randn((m, spec.row_width), device="cuda",
                                 generator=gen)))
    recs = {}
    for label, n_rows, rows, upd in cases:
        want = sk.scatter_add_rows_plain(rows, upd, n_rows)
        got = real(rows, upd, n_rows)
        torch.cuda.synchronize()
        frac = _frac_err(got, want)
        if frac > K3_FRAC:
            raise AssertionError(f"scatter_add_rows {label}: error {frac} "
                                 f"of the largest entry (limit {K3_FRAC})")
        rows_m, w = upd.shape
        nnz = int((upd != 0).sum().item())
        t_bytes = (rows_m * 4 + upd.numel() * 4 + n_rows * w * 4) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = nnz / F32_FLOPS * 1e3       # one add per nonzero lane
        t_algo = t_bytes + _ordered_bytes(rows_m, n_rows, False) \
            / HBM_BYTES_PER_S * 1e3

        def index_add():
            return torch.zeros((n_rows, w), device="cuda").index_add_(
                0, rows, upd)

        det = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            det_ms = cuda_ms(index_add, 20)
        finally:
            torch.use_deterministic_algorithms(det)
        rec = {"name": "scatter_add_rows", "case": label, "m": rows_m,
               "w": w, "n_rows": n_rows, "tile": sk.reduce_tile(w),
               "nonzero_lanes": nnz,
               "max_abs_err": (got - want).abs().max().item(),
               "err_frac": frac, "table_max": want.abs().max().item(),
               "ms": cuda_ms(lambda: real(rows, upd, n_rows), 20),
               "plain_ms": cuda_ms(
                   lambda: sk.scatter_add_rows_plain(rows, upd, n_rows), 5),
               "library_ms": cuda_ms(index_add, 20),
               "library_det_ms": det_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "algo_bound_ms": max(t_algo, t_ops)}
        if label == "hashed level, row form":
            # the same sums as the corner entries (1e-4 of the largest)
            corner = recs["hashed level"]["_got"].view(n_rows, w)
            rec["err_frac_vs_corner_form"] = _frac_err(got, corner)
            if rec["err_frac_vs_corner_form"] > K3_FRAC:
                raise AssertionError(f"K3 row form vs corner form: {rec}")
        log(json.dumps({"kernel_check": rec}))
        rec["_got"] = got
        recs[label] = rec
        del want
    for rec in recs.values():
        del rec["_got"]
    sort_keys = _sort_key_sets(cases)
    del cases, rows_f, upd_f
    torch.cuda.empty_cache()
    return recs, sort_keys


def torch_key_sort(keys, n_keys, lib=None):
    """key_sort's function by torch.sort(stable=True) (the library sort it
    replaced): keys outside [0, n_keys) as n_keys, an int32 index. Phase 8b
    holds the kernel to it; phase 18 feeds the reduces its permutation."""
    import torch
    k = torch.where((keys >= 0) & (keys < n_keys), keys, n_keys)
    s, p = torch.sort(k, stable=True)
    return s, p.to(torch.int32)


def _sort_reading(keys, n_keys, lib):
    """One library's key_sort on one key set: CUDA events over 20 calls,
    profiler device time over 5 (bench.device_ms, a window that kept every
    call), each of its kernels' calls and device ms a sort, and the
    kernels and device operations a sort launches."""
    from cednerf_torch.ops import scatter_kernels as sk
    from cednerf_torch.utils.bench import cuda_ms, device_ms

    dev, rows, seen = device_ms(lambda: sk.key_sort(keys, n_keys, lib), 5,
                                need_all=True)
    return {"ms": cuda_ms(lambda: sk.key_sort(keys, n_keys, lib), 20),
            "device_ms": dev, "device_calls_seen": seen,
            "device_by_kernel": [[r[0], r[1] / 5, r[2] / 5] for r in rows],
            "kernels_a_sort": sum(r[1] for r in rows
                                  if "keysort::" in r[0]) / 5,
            "device_ops_a_sort": sum(r[1] for r in rows) / 5}


def key_sort_phase(spec, seed, n, sort_keys, others=()):
    """Phase 8b: the key-width sort (key_sort, csrc/key_sort.cuh, as each
    of its two libraries exports it) against torch.sort(stable=True), the
    sorted keys and the permutation bit for bit, on K6's keys of one train
    step (N samples x L levels of the full-width field, drawn as phase 3
    draws them, INT_MAX where a cotangent row is zero), on the same with
    every sample in one level-0 brick, on the hash4d hashed level's corner
    keys and the tri-plane's texel keys (phase 8's, `sort_keys`), on a
    ragged 100,003 keys with some outside the table and on 2,097,152 equal
    keys; each read by _sort_reading (events, device time, each kernel's
    device time, the kernels a sort launches), beside torch.sort of the
    same keys (`library_ms`). One sort is dispatched under
    torch.cuda.set_sync_debug_mode("error"): it reads nothing back to the
    host. `others`, [(name, KernelLibrary)] of other checkouts' key_sort
    (sort_ab_main): each is held to torch.sort too and read in turns with
    this tree's (the others, this, this, the others in reverse) under
    "turns". Returns {case: record}."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops import scatter_kernels as sk
    from cednerf_torch.utils.bench import cuda_ms, device_ms

    level_rows = [l["rows"] for l in spec.level_layout()]
    L, F = spec.n_levels, spec.n_features
    n_table = sum(level_rows)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = (torch.randn((n, L * F), device="cuda", generator=gen) * 1e-3
         ).to(torch.bfloat16)
    g[::8] = 0
    ragged = torch.randint(-3, n_table + 3, (100_003,), device="cuda",
                           generator=gen, dtype=torch.int32)
    ragged[::97] = torch.iinfo(torch.int32).max
    cases = {
        "k6 uniform": (_k6_keys(_level_rows(_draw_x(n, gen, None), spec), g,
                                level_rows, F).reshape(-1), n_table),
        "k6 one brick": (_k6_keys(_level_rows(_one_brick_x(
            n, gen, spec.level_scales()[0]), spec), g, level_rows,
            F).reshape(-1), n_table),
        **sort_keys,
        "ragged": (ragged, n_table),
        "equal": (torch.full((n * L,), 17, dtype=torch.int32,
                             device="cuda"), n_table)}
    keys, n_keys = cases["k6 uniform"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sk.key_sort(keys, n_keys)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out = {}
    for label, (keys, n_keys) in cases.items():
        m = keys.numel()
        want = torch_key_sort(keys, n_keys)
        equal = {}
        for name, lib in [(sk._LIB.stem, sk._LIB), (ek._BWD.stem, ek._BWD),
                          *others]:
            got = sk.key_sort(keys, n_keys, lib)
            torch.cuda.synchronize()
            equal[name] = bool(torch.equal(got[0], want[0])
                               and torch.equal(got[1], want[1]))
        if not all(equal.values()):
            raise AssertionError(f"key_sort {label}: not torch.sort's "
                                 f"permutation: {equal}")
        bits, passes, dbits = sk.sort_plan(n_keys)
        # the function's bytes: the keys read once, the sorted keys and the
        # permutation written once; no arithmetic beyond the compares
        t_bytes = m * 12 / HBM_BYTES_PER_S * 1e3
        lib_dev, _, lib_seen = device_ms(
            lambda: torch.sort(keys, stable=True), 5)
        rec = {"name": "key_sort", "case": label, "m": m, "n_keys": n_keys,
               "bits": bits, "passes": passes, "digit_bits": dbits,
               "bit_exact": equal, "max_abs_err": 0,
               **_sort_reading(keys, n_keys, sk._LIB),
               "library_ms": cuda_ms(lambda: torch.sort(keys, stable=True),
                                     20),
               "library_device_ms": lib_dev,
               "library_calls_seen": lib_seen,
               "bound_ms": t_bytes, "bound_by": "bytes",
               "algo_bound_ms": _sort_bytes(m, n_keys) / HBM_BYTES_PER_S
               * 1e3}
        if label == "k6 uniform":
            rec["plain_ms"] = cuda_ms(
                lambda: sk.key_sort_plain(keys, n_keys), 1)
        if others:
            this = [("this", sk._LIB)]
            rec["turns"] = [
                dict(tree=name, turn=i, **_sort_reading(keys, n_keys, lib))
                for i, (name, lib) in enumerate(
                    [*others, *this, *this, *others[::-1]])]
        log(json.dumps({"kernel_check": rec}))
        out[label] = rec
        del want
    del cases
    torch.cuda.empty_cache()
    return out


def _fresh_process_phase(flag, seed, inputs=None):
    """A phase run by a new process of this script (`flag`, its own main),
    for its profiler readings: in a process that has run the earlier
    phases the profiler keeps too few device records (bench.device_ms
    refuses such a window), in a new one it keeps them all. `inputs`, {name:
    (tensor, int)}, go to the child through a file; its log lines go to
    this output; it writes its result as JSON, which this returns."""
    import shutil
    import subprocess
    import tempfile

    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_phase_")
    try:
        if inputs is not None:
            torch.save({k: (t.cpu(), n) for k, (t, n) in inputs.items()},
                       os.path.join(work, "inputs.pt"))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), flag, work,
             "--seed", str(seed)], timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"{flag} exited {proc.returncode}")
        with open(os.path.join(work, "out.json")) as fh:
            return json.load(fh)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def sort_phase_main(work, seed):
    """Phase 8b (key_sort_phase) in its own process (_fresh_process_phase):
    the hash4d and tri-plane keys from work/inputs.pt, the result to
    work/out.json."""
    import torch
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.utils.bench import TRAIN_FLAGS

    cfg = dnerf_config()
    spec = build_field(cfg, ModelFlags(**TRAIN_FLAGS), device="cuda",
                       seed=seed).hash_encoder.bspec
    keys = torch.load(os.path.join(work, "inputs.pt"))
    out = key_sort_phase(spec, seed, cfg.sample_budget,
                         {k: (t.cuda(), n) for k, (t, n) in keys.items()})
    with open(os.path.join(work, "out.json"), "w") as fh:
        json.dump(out, fh, default=str)


def _other_ops(root):
    """(ops/encode_kernels, ops/scatter_kernels) of the checkout at `root`
    (for example the parent commit unpacked by `git archive` into a
    git-ignored directory), imported as a package of its own name: its own
    wrappers, launch counters and resident buffers, its libraries built by
    its own build module from its own sources into its own _build."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "cednerf_torch")
    name = f"ab_{abs(hash(pkg))}_cednerf_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.ops.encode_kernels"),
            importlib.import_module(f"{name}.ops.scatter_kernels"))


def _repro_specs(seed):
    """Phase 18's specs: the 3D, cell-layout and hash4d fields' brick
    grids."""
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.utils.bench import HASH4D_FLAGS, TRAIN_FLAGS

    cfg = dnerf_config()
    return [build_field(c, ModelFlags(**fl), device="cuda",
                        seed=seed).hash_encoder.bspec
            for c, fl in ((cfg, TRAIN_FLAGS),
                          (dataclasses.replace(cfg, row_layout="cell",
                                               fine_table_rows=65536),
                           TRAIN_FLAGS), (cfg, HASH4D_FLAGS))]


def _reduce_call(ek, ctx, c, keys):
    """table_reduce of the module ek on K6's keys of case c, into a table
    gradient of its own that starts zero."""
    import torch

    d_t = torch.zeros((ctx["n_table"], 64 * ctx["F"]), device="cuda")
    return lambda: ek.table_reduce(keys, c["x"], c["g"], ctx["scales"],
                                   ctx["nbs"], ctx["level_rows"], ctx["F"],
                                   d_t)


def reduce_ab_phase(others, seed):
    """Phase 18's kernels K6, K6c, K2 and K3 and its reduce path (the sort
    and the reduce with its carry, on K6's keys) on its three inputs, by
    this tree's wrappers and by each other checkout's (others: [(name,
    (encode_kernels, scatter_kernels))], _other_ops): every output held
    bit-equal to this tree's, CUDA-event ms in turns (the others, this,
    this, the others in reverse) and each tree's profiler device ms by
    kernel. A reduce_ab line a (kernel, input); returns them."""
    import torch
    from cednerf_torch.engine.config import dnerf_config
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops import scatter_kernels as sk
    from cednerf_torch.utils.bench import cuda_ms, device_ms

    trees = [("this", (ek, sk)), *others]
    turns = [*others, trees[0], trees[0], *others[::-1]]
    ctx = _repro_setup(*_repro_specs(seed), seed,
                       dnerf_config().sample_budget)
    torch.cuda.empty_cache()
    recs = []
    for label, x in ctx["inputs"].items():
        case = _repro_case(ctx, x)
        keys = _k6_keys(case["rows"], case["g"], ctx["level_rows"],
                        ctx["F"])
        calls = {}
        for name, (e, s_) in trees:
            calls[name] = _repro_calls(e, s_, ctx, case)
            calls[name]["table_reduce"] = _reduce_call(e, ctx, case, keys)
        for kernel in calls["this"]:
            ref = [t.clone() for t in calls["this"][kernel]()
                   if t is not None]
            equal = {}
            for name, _ in others:
                got = [t for t in calls[name][kernel]() if t is not None]
                equal[name] = len(got) == len(ref) and all(
                    _same_bits(a, b) for a, b in zip(ref, got))
            torch.cuda.synchronize()
            del ref
            if not all(equal.values()):
                raise AssertionError(f"reduce_ab {kernel} {label}: other "
                                     f"bits than this tree's: {equal}")
            rec = {"kernel": kernel, "input": label, "bit_equal": equal,
                   "turns": [{"tree": name, "ms": cuda_ms(
                       calls[name][kernel], 20)} for name, _ in turns],
                   "device": {}}
            for name, _ in trees:
                try:
                    dev, krows, _ = device_ms(calls[name][kernel], 5,
                                              need_all=True)
                except RuntimeError as err:   # the profiler dropped calls
                    rec["device"][name] = {"not_measured": str(err)}
                    continue
                rec["device"][name] = {
                    "device_ms": dev,
                    "kernels_a_call": sum(r[1] for r in krows) / 5,
                    "by_kernel": [[r[0][:60], r[1] / 5, r[2] / 5]
                                  for r in krows[:8]]}
            log(json.dumps({"reduce_ab": rec}))
            recs.append(rec)
        del calls, case, keys
        torch.cuda.empty_cache()
    return recs


def sort_ab_main(roots, seed):
    """This tree's key sort and ordered reduces against each checkout's in
    `roots`, in turns on one card: phase 18's kernels and reduce path
    (reduce_ab_phase), then phase 8b's key sets (key_sort_phase; the
    hash4d and tri-plane keys from _k3_inputs) sorted by this tree's
    key_sort and by each checkout's, every library held to torch.sort's
    permutation bit for bit. Prints the card, a reduce_ab line a (kernel,
    input), a kernel_check line a key set, then {"ok": true}."""
    import torch
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.ops.cuda_build import build_all
    from cednerf_torch.utils.bench import TRAIN_FLAGS, card_name

    log(card_name())
    build_all()
    others = [(os.path.basename(os.path.normpath(r)), _other_ops(r))
              for r in roots]
    for _, (e, s_) in others:
        e._BWD.get()
        s_._LIB.get()
    reduce_ab_phase(others, seed)
    cfg = dnerf_config()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _, cases = _k3_inputs(cfg, seed, gen)
    sort_keys = _sort_key_sets(cases)
    del cases
    spec = build_field(cfg, ModelFlags(**TRAIN_FLAGS), device="cuda",
                       seed=seed).hash_encoder.bspec
    torch.cuda.empty_cache()
    key_sort_phase(spec, seed, cfg.sample_budget, sort_keys,
                   [(name, s_._LIB) for name, (_, s_) in others])
    log(card_name())
    print(json.dumps({"ok": True}))


def repro_kernels_main(work, seed):
    """Phase 18's kernel part (repro_kernel_phase) in its own process
    (_fresh_process_phase), on the 3D, cell-layout and hash4d fields'
    specs; the result to work/out.json."""
    import torch
    from cednerf_torch.engine.config import dnerf_config

    specs = _repro_specs(seed)
    torch.cuda.empty_cache()
    out = repro_kernel_phase(*specs, seed, dnerf_config().sample_budget)
    with open(os.path.join(work, "out.json"), "w") as fh:
        json.dump(out, fh, default=str)


# the steady-state steps of the reference step phase (hash3d), each as
# tests/test_torch_steady_march.py holds it against JAX: (config change,
# step option). The skip lattice runs on a 64^3 grid and a 256-slot probe,
# so that the probe's pooled cells leave some spans inside its 112 slots.
STEADY_REF = {
    "skip": (dict(steady_march_steps=112, max_march_steps=256,
                  grid_resolution=64), dict(steady_march=True)),
    "s_cap": (dict(), dict(s_cap=24)),
    "seg": (dict(march_seg=8, seg_overcommit=2.0), dict(use_seg=True)),
}


def _shell_bins(res, rng, radius=0.55, width=0.2, noise=0.01):
    """[1, res, res, res] bool: a carved grid, the cells of a shell about
    the centre plus `noise` random cells."""
    import numpy as np
    c = (np.arange(res) + 0.5) / res * 3.0 - 1.5
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)
    return ((np.abs(r - radius) < width)
            | (rng.uniform(size=r.shape) < noise))[None]


def _ref_step_runs(cfg, flags, bins, batch, jitter, seed, routes,
                   step_kw=None, density_bias=None, encoder_impl="brick",
                   compute_dtype=None):
    """One loss-and-gradients step of `cfg` per route: ("plain", CPU) and
    each route of `routes` on the card, from the same weights, grid (bins
    [levels, res, res, res]), batch and jitter; density_bias, if given,
    replaces the density output's bias; compute_dtype, if given, is every
    module's compute dtype (the MLPs' and the encoder's) on both sides, or
    {"encoder": dtype, "mlp": dtype}: the encoder's, the other modules'.
    {route: (loss, aux floats, gradients on the CPU)}."""
    import numpy as np
    import torch
    from cednerf_torch.bridge import occ_from_numpy
    from cednerf_torch.engine import train as tt
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.ops.occupancy import create_occ_grid
    from cednerf_torch.utils.bench import load_uniform_tables

    levels = bins.shape[0]
    occs = np.where(bins, 0.5, 0.0).astype(np.float32).reshape(levels, -1)
    aabbs = create_occ_grid(cfg.aabb, bins.shape[-1], levels,
                            device="cpu").aabbs.numpy()
    runs = {}
    for route, dev in (("plain", "cpu"),) + tuple((r, "cuda")
                                                 for r in routes):
        c = dataclasses.replace(cfg, interp_impl=route)
        f = build_field(c, flags, device=dev, seed=seed,
                        encoder_impl=encoder_impl)
        load_uniform_tables([f], seed, 1.0)
        if compute_dtype is not None:
            for name, m in f.named_modules():
                if hasattr(m, "dtype"):
                    m.dtype = compute_dtype if not isinstance(
                        compute_dtype, dict) else compute_dtype[
                            "encoder" if name.startswith("hash_encoder")
                            else "mlp"]
        if density_bias is not None:
            with torch.no_grad():
                f.mlp_base.out.bias[0] = density_bias
        state = tt.create_train_state(f, c, device=dev)
        state.occ = occ_from_numpy(occs, bins, aabbs, device=dev)
        loss, aux = tt._make_loss_fn(c, flags, c.sample_budget,
                                     **(step_kw or {}))(
            state, {k: torch.as_tensor(np.asarray(v)).to(dev)
                    for k, v in batch.items()},
            jitter=torch.from_numpy(jitter).to(dev))
        runs[route] = (loss.item(), {k: v.item() for k, v in aux.items()},
                       {n: p.grad.detach().float().cpu()
                        for n, p in f.named_parameters()})
    return runs


def _ref_step_check(label, runs, routes):
    """Each card route against the CPU run: n_valid (and, on the steady
    steps, complete_frac and span_slots) exact, the loss within
    STEP_LOSS_RTOL, every gradient within STEP_GRAD_REL of its norm."""
    loss0, aux0, g0 = runs["plain"]
    rec = {"cpu_loss": loss0, "n_valid": aux0["n_valid"],
           "complete_frac": aux0["complete_frac"],
           "span_slots": aux0["span_slots"]}
    for route in routes:
        loss, aux, grads = runs[route]
        rels = {n: ((grads[n] - g0[n]).norm() / g0[n].norm()).item()
                for n in g0 if g0[n].norm() > 0}
        worst = max(rels, key=rels.get)
        rec[route] = {"loss": loss, "loss_rel_err": abs(loss - loss0) / loss0,
                      "n_valid": aux["n_valid"],
                      "worst_grad": worst, "worst_grad_rel_err": rels[worst],
                      "encoder_grad_rel_err": {
                          n: rels[n] for n in rels if "hash_encoder" in n}}
        for k in ("n_valid", "complete_frac", "span_slots"):
            if aux[k] != aux0[k]:
                raise AssertionError(f"{label} ({route}): {k} {aux[k]} != "
                                     f"{aux0[k]}")
        if abs(loss - loss0) > STEP_LOSS_RTOL * abs(loss0):
            raise AssertionError(f"{label} ({route}): loss {loss} vs "
                                 f"{loss0}")
        if rels[worst] > STEP_GRAD_REL:
            raise AssertionError(f"{label} ({route}): gradient of "
                                 f"{worst} off by {rels[worst]}: {rec}")
    return rec


def reference_step_phase(seed, grid_type="hash3d"):
    """One train step of the shrunken config (SMALL) on the card, through
    each kernel route (for hash4d the one route: its backward on K3), and
    on the CPU through the plain versions: the same
    weights (tables uniform(-1, 1), so that the MLPs feel them), occupancy
    grid (30% of cells, numpy), ray batch (BallScene) and march jitter.
    n_valid must match, the loss within STEP_LOSS_RTOL, and each
    parameter's gradient within STEP_GRAD_REL of its L2 norm, the
    limits set out beside them (between the sound reading and a fault's).
    A backward kernel that dropped a corner, a level or the position
    gradient would move the table or motion-MLP gradients far past that.
    For hash3d, then the steady-state steps of STEADY_REF (skip lattice,
    s_cap, march_seg with K4 twice) on a carved grid, the card's default
    route against the CPU, with complete_frac and span_slots exact too."""
    import numpy as np
    from cednerf_torch.datasets.procedural import BallScene
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.utils.bench import TRAIN_FLAGS

    cfg = dataclasses.replace(dnerf_config(), **SMALL)
    flags = ModelFlags(**TRAIN_FLAGS, grid_type=grid_type)
    routes = ("xla", "interp") if grid_type == "hash3d" else ("xla",)
    rng = np.random.default_rng(seed)
    res = cfg.grid_resolution
    bins = rng.uniform(size=(1, res, res, res)) < 0.3
    batch = BallScene(n_cams=4, wh=32, n_times=4, seed=seed).sample(128)
    jitter = rng.uniform(size=128).astype(np.float32)
    rec = {"grid_type": grid_type, **_ref_step_check(
        "reference step", _ref_step_runs(cfg, flags, bins, batch, jitter,
                                         seed, routes), routes)}
    if grid_type != "hash3d":
        return rec
    for name, (cfg_kw, step_kw) in STEADY_REF.items():
        c = dataclasses.replace(cfg, **cfg_kw)
        sbins = _shell_bins(c.grid_resolution, rng)
        rec[name] = _ref_step_check(
            f"reference step {name}",
            _ref_step_runs(c, flags, sbins, batch, jitter, seed, ("xla",),
                           step_kw), ("xla",))
        if not 0.0 < rec[name]["complete_frac"] < 1.0:
            raise AssertionError(f"reference step {name}: complete_frac "
                                 f"{rec[name]['complete_frac']} is not a "
                                 "mix of cut and whole rays")
    return rec


def _drive(trainer, cfg, n, label):
    """`n` steps of trainer.run_step with every launch counter zeroed just
    before and read just after: (per-step records, launch counts). Fails on
    a non-finite loss or a plain version run on CUDA."""
    import numpy as np
    import torch

    reset_counts()
    recs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        occ_step = trainer.step % cfg.occ_update_interval == 0
        m = trainer.run_step()
        torch.cuda.synchronize()
        m["ms"] = (time.perf_counter() - t0) * 1e3
        m["occ_update"] = occ_step
        if not np.isfinite(m["loss"]):
            raise AssertionError(f"{label} step {trainer.step}: loss "
                                 f"{m['loss']}")
        recs.append(m)
    counts, plain = all_counts()
    if any(plain.values()):
        raise AssertionError(f"{label}: plain versions ran on CUDA: {plain}")
    no_probe_kernels(label, counts)
    return recs, counts


def _train_summary(recs, cfg, counts, tag):
    """PSNR rise (fails unless the last 8 steps' mean is above the first
    8's), step times and rates; logs a few steps' records under `tag`."""
    import numpy as np

    steps = len(recs)
    psnr = [r["psnr"] for r in recs]
    first, last = float(np.mean(psnr[:8])), float(np.mean(psnr[-8:]))
    if not last > first:
        raise AssertionError(f"{tag}: PSNR did not rise: first 8 {first}, "
                             f"last 8 {last}")
    steady = [r for r in recs[cfg.occ_warmup_steps:] if not r["occ_update"]]
    warm = [r for r in recs[:cfg.occ_warmup_steps] if not r["occ_update"]]
    step_ms = float(np.median([r["ms"] for r in steady or recs]))
    for i in sorted({0, 7, cfg.occ_warmup_steps - 1, steps - 1}):
        if i < steps:
            log(json.dumps({tag: i, **recs[i]}))
    return {
        "steps": steps, "psnr_first8": first, "psnr_last8": last,
        "median_ms_per_step": step_ms,
        "median_ms_per_warmup_step": float(np.median(
            [r["ms"] for r in warm])) if warm else None,
        "occ_update_step_ms": float(np.median(
            [r["ms"] for r in recs if r["occ_update"]])),
        "budget_slots_per_s": cfg.sample_budget / step_ms * 1e3,
        "valid_samples_per_s": float(np.median(
            [r["n_samples"] / r["ms"] * 1e3 for r in steady or recs])),
        "last": {k: recs[-1][k] for k in ("num_rays", "n_valid", "n_samples",
                                          "complete_frac", "loss", "psnr")},
        "buckets_visited": sorted({r["num_rays"] for r in recs}),
        "launches": counts}


def training_phase(cfg, flags, seed, steps=TRAIN_STEPS,
                   interp_steps=INTERP_STEPS):
    """Trainer.run_step at full width: `steps` default-route steps, then
    `interp_steps` on the K1/K2 route, with launch counts per route."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.procedural import BallCloudScene
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.ops import compact_kernels as ck
    from cednerf_torch.ops import encode_kernels as ek

    field = build_field(cfg, flags, device="cuda", seed=seed)
    trainer = Trainer(field, cfg, flags, BallCloudScene(seed=seed),
                      seed=seed, device="cuda")

    recs, counts = _drive(trainer, cfg, steps, "default route")
    for k in ("fused_encode_fwd", "fused_encode_bwd", "compact_select"):
        if counts[k] == 0:
            raise AssertionError(f"default route: {k} never launched: "
                                 f"{counts}")
    if (counts["interp_fwd"] or counts["interp_bwd_fused"]
            or counts["scatter_add_rows"]):
        raise AssertionError(f"default route took K1/K2/K3: {counts}")
    summary = _train_summary(recs, cfg, counts, "train_step")

    spec = field.hash_encoder.bspec
    field.hash_encoder.bspec = dataclasses.replace(spec, interp_impl="interp")
    irecs, icounts = _drive(trainer, cfg, interp_steps, "interp route")
    for k in ("interp_fwd", "interp_bwd_fused", "compact_select"):
        if icounts[k] == 0:
            raise AssertionError(f"interp route: {k} never launched: "
                                 f"{icounts}")
    if (icounts["fused_encode_fwd"] or icounts["fused_encode_bwd"]
            or icounts["scatter_add_rows"]):
        raise AssertionError(f"interp route took K5/K6/K3: {icounts}")
    summary["interp"] = {
        "steps": interp_steps, "launches": icounts,
        "median_ms_per_step": float(np.median([r["ms"] for r in irecs])),
        "psnr": [r["psnr"] for r in irecs]}
    return summary


def _occ_probe_launches(cfg, step0, steps, warmup_phase):
    """K5 launches of the occupancy updates in steps [step0, step0 +
    steps): one per 65,536-position chunk of update_occ_grid, all cells
    while a warmup-phase chunk is below occ_warmup_steps, a quarter after."""
    cells = cfg.grid_nlvl * cfg.grid_resolution ** 3
    n = 0
    for step in range(step0, step0 + steps):
        if step % cfg.occ_update_interval == 0:
            warm = warmup_phase and step < cfg.occ_warmup_steps
            n += -(-(cells if warm else int(cells * 0.25)) // 2 ** 16)
    return n


def _record_chunks(trainer, recs):
    """Wrap trainer.run_chunk (the one Trainer.run calls) to record each
    chunk: its metrics, first step, lattice, phase and host ms. Fails on a
    non-finite loss."""
    import numpy as np
    import torch

    chunk = trainer.run_chunk

    def recorded():
        step0, lattice = trainer.step, trainer.steady_march
        warm = trainer._warmup_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = chunk()
        ms = (time.perf_counter() - t0) * 1e3
        if not np.isfinite(m["loss"]):
            raise AssertionError(f"scanned chunk at step {step0}: loss "
                                 f"{m['loss']}")
        recs.append({**m, "step0": step0, "lattice": lattice,
                     "warmup": warm, "ms": ms})
        return m

    trainer.run_chunk = recorded


def _check_step_launches(label, counts, plain, cfg, recs, k4_per_step=1,
                         bwd="fused_encode_bwd", encoders=1, k3_per_step=0):
    """The backward kernel `bwd` (K6, or K6c on the cell layouts, with
    fold_cells as often: one launch for every cell level) `encoders` times
    a step (the brick encoders a step runs: 2 with the hash-grid motion
    warp, 0 for the tri-plane and per-corner encoders), each with one
    table-gradient reduce (its carry folded in), K4 k4_per_step times, K3
    k3_per_step times (the tri-plane's texel gradient), the sort once for
    each reduce, K5 `encoders` times a step and as often per occupancy
    probe, nothing else, no plain version on CUDA."""
    if any(plain.values()):
        raise AssertionError(f"{label}: plain versions ran on CUDA: {plain}")
    no_probe_kernels(label, counts)
    steps = sum(r["steps"] for r in recs)
    want = {"fused_encode_fwd": encoders * (steps + sum(
                _occ_probe_launches(cfg, r["step0"], r["steps"], r["warmup"])
                for r in recs)),
            "fused_encode_bwd": 0, "fused_encode_bwd_cell": 0,
            "fold_cells": 0, "compact_select": k4_per_step * steps,
            "interp_fwd": 0, "interp_bwd_fused": 0,
            "table_reduce": encoders * steps,
            "scatter_add_rows": k3_per_step * steps,
            "key_sort": (encoders + k3_per_step) * steps}
    want[bwd] = encoders * steps
    if bwd == "fused_encode_bwd_cell":
        want["fold_cells"] = encoders * steps
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def _sync_checked_chunk(trainer):
    """One chunk of `trainer`: its dispatch under
    set_sync_debug_mode("error") (a host sync inside raises), then a whole
    run_chunk under "warn", whose synchronizing calls are counted and must
    be exactly one (the chunk's metrics read). Returns the count."""
    import numpy as np
    import torch

    from cednerf_torch.utils.bench import sync_calls

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = trainer.dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not np.isfinite(metrics.cpu().numpy()[:, 0]).all():
        raise AssertionError(f"sync-checked chunk: losses {metrics}")
    # the class's run_chunk, not _record_chunks' timed wrapper
    m, syncs = sync_calls(lambda: type(trainer).run_chunk(trainer))
    if len(syncs) != 1 or not np.isfinite(m["loss"]):
        raise AssertionError(f"run_chunk: {len(syncs)} host syncs (want 1: "
                             f"the metrics read): {syncs}")
    return len(syncs)


@contextlib.contextmanager
def _keeping_k4(kept, label):
    """Within the block, K4's wrapper (ops/compact_kernels.py, which the
    renderer calls through its module) keeps in `kept`, for each (lattice
    shape, budget), the lattice and result of the call that selected the
    most candidates (the first call's if none selected more), with the
    label of the path that first made that shape. The choice is made on
    the card (torch.where on the counts), so keeping adds no host sync."""
    import torch
    from cednerf_torch.ops import compact_kernels as ck
    real = ck.compact_select_kernel

    def keep(valid, budget, n_blocks=1):
        sel, sel_kept = real(valid, budget, n_blocks)
        key = (tuple(valid.shape), budget, n_blocks)
        n = sel_kept.sum()
        if key not in kept:
            kept[key] = (label, valid.clone(), sel.clone(), sel_kept.clone(),
                         n)
        else:
            lab, v0, s0, k0, n0 = kept[key]
            more = n > n0
            kept[key] = (lab, torch.where(more, valid, v0),
                         torch.where(more, sel, s0),
                         torch.where(more, sel_kept, k0),
                         torch.maximum(n, n0))
        return sel, sel_kept

    ck.compact_select_kernel = keep
    try:
        yield
    finally:
        ck.compact_select_kernel = real


def _check_k4_kept(kept):
    """Each result _keeping_k4 kept, bit-exact against its plain version
    on the same lattice (compact_select_rayfold; compact_select for a
    blocked call), run after the paths' launch counts were read."""
    import torch
    from cednerf_torch.ops import compact_kernels as ck
    recs = []
    for (shape, budget, nbk), (label, valid, sel, sel_kept, _) in \
            kept.items():
        want = (ck.compact_select_rayfold(valid, budget) if nbk == 1
                else ck.compact_select(valid, budget, nbk))
        torch.cuda.synchronize()
        if not (torch.equal(sel, want[0]) and torch.equal(sel_kept, want[1])):
            raise AssertionError(f"compact_select on the {label} path's "
                                 f"{shape} lattice, budget {budget}, "
                                 f"{nbk} block(s): differs from its plain "
                                 "version")
        rec = {"name": "compact_select" if nbk == 1
               else "compact_select_blocks", "path": label,
               "lattice": list(shape), "budget": budget, "n_blocks": nbk,
               "tiles": nbk * -(-(valid.numel() // nbk) // ck.TILE),
               "max_abs_err": 0,
               "n_valid": int(valid.sum().item()),
               "n_selected": int(sel_kept.sum().item())}
        log(json.dumps({"kernel_check": rec}))
        recs.append(rec)
    kept.clear()
    return recs


def scanned_phase(cfg, flags, seed, steps=SCANNED_STEPS, k=SCANNED_K,
                  ckpt_every=SCANNED_CKPT):
    """Trainer.run(steps) through run_chunk at full width: BallCloudScene's
    device sampler, k steps a chunk (the occupancy warmup, then steady
    chunks with the shrink-from-full adaptation), a rolling checkpoint
    every ckpt_every steps, the one at ckpt_every kept. Fails unless every
    loss is finite, the last chunk's PSNR tops the first's and the launch
    counts are K6 and K4 once a step and K5 once a step plus the probes.
    Then from the kept checkpoint, fresh Trainers: the empty-space-skip
    lattice for 2 chunks (unless the shrink already ran it for 2), a
    resume that must restore step, bucket and lattice, march_seg (K4 twice
    a step) and stacked host batches, 2 chunks each; one skip-lattice
    chunk's dispatch under sync-debug "error" and one run_chunk with
    exactly one host sync. K4's result on the first lattice of each shape
    and budget that these runs hand it (the full and skip lattices at each
    ray bucket, march_seg's segment and sample lattices) is held bit-exact
    against its plain version."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from cednerf_torch.datasets.procedural import BallCloudScene
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.train import Trainer

    scene = BallCloudScene(seed=seed)
    k4 = {}       # (lattice shape, budget) -> K4's first call there
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    roll, kept = os.path.join(tmp, "rolling"), os.path.join(tmp, "kept")

    def trainer_for(c, **kw):
        if not kw.get("stacked_host"):
            kw["device_sampler"] = scene.device_sampler()
        return Trainer(build_field(c, flags, device="cuda", seed=seed), c,
                       flags, scene, seed=seed, device="cuda",
                       steps_per_call=k, **kw)

    def two_chunks(label, trainer, k4_per_step=1):
        recs = []
        _record_chunks(trainer, recs)
        reset_counts()
        with _keeping_k4(k4, label):
            for _ in range(2):
                trainer.run_chunk()
        counts, plain = all_counts()
        _check_step_launches(label, counts, plain, trainer.cfg, recs,
                             k4_per_step)
        return recs, counts

    try:
        main = trainer_for(cfg)
        recs, saved = [], {}
        _record_chunks(main, recs)

        def keep():       # the rolling checkpoint written at ckpt_every
            shutil.copytree(roll, kept)
            saved.update(step=main.step, bucket=main.bucket,
                         lattice=main.steady_march)

        t0 = time.perf_counter()
        reset_counts()
        with _keeping_k4(k4, "scanned run"):
            main.run(steps, log_every=0, hooks=[(ckpt_every, keep)],
                     checkpoint_dir=roll, checkpoint_every=ckpt_every)
        counts, plain = all_counts()
        run_s = time.perf_counter() - t0
        _check_step_launches("scanned run", counts, plain, cfg, recs)
        if not recs[-1]["psnr"] > recs[0]["psnr"]:
            raise AssertionError(f"scanned run: PSNR {recs[0]['psnr']} -> "
                                 f"{recs[-1]['psnr']}")
        if saved.get("step") != ckpt_every:
            raise AssertionError(f"no checkpoint at step {ckpt_every}: "
                                 f"{saved}")
        skip = [r for r in recs if not r["warmup"]
                and 0 < r["lattice"] < cfg.max_march_steps]
        steady = [r for r in recs if not r["warmup"]]
        out = {"steps": main.step, "chunks": len(recs), "run_s": run_s,
               "launches": counts, "psnr_first": recs[0]["psnr"],
               "psnr_last": recs[-1]["psnr"],
               "median_ms_per_step_warmup": float(np.median(
                   [r["ms"] / r["steps"] for r in recs if r["warmup"]])),
               "median_ms_per_step_steady": float(np.median(
                   [r["ms"] / r["steps"] for r in steady])),
               "lattices": sorted({r["lattice"] for r in recs}),
               "buckets": sorted({r["num_rays"] for r in recs}),
               "last": {x: recs[-1][x] for x in (
                   "num_rays", "n_valid", "n_samples", "complete_frac",
                   "loss", "psnr")}}
        for r in recs[:1] + recs[15:17] + recs[-1:]:
            log(json.dumps({"scanned_chunk": r}))
        if len(skip) >= 2:
            out["skip_lattice"] = {"by": "shrink-from-full",
                                   "lattice": main.steady_march,
                                   "chunks": len(skip)}
            sync_trainer = main
        else:
            pinned = trainer_for(dataclasses.replace(
                cfg, steady_march_steps=PINNED_LATTICE))
            pinned.resume(kept)
            prec, pcounts = two_chunks("pinned skip lattice", pinned)
            out["skip_lattice"] = {
                "by": f"steady_march_steps={PINNED_LATTICE} pinned, "
                      f"resumed at step {ckpt_every} (the shrink did not "
                      f"fire in {len(steady)} steady chunks)",
                "lattice": pinned.steady_march, "chunks": len(prec),
                "complete_frac": [r["complete_frac"] for r in prec],
                "ms_per_step": [r["ms"] / r["steps"] for r in prec],
                "launches": pcounts}
            sync_trainer = pinned
        log(json.dumps({"scanned_skip": out["skip_lattice"]}))
        out["syncs_per_chunk"] = _sync_checked_chunk(sync_trainer)
        del main, sync_trainer
        torch.cuda.empty_cache()

        res = trainer_for(cfg)
        at = res.resume(kept)
        got = {"step": at, "bucket": res.bucket, "lattice": res.steady_march}
        if got != saved:
            raise AssertionError(f"resume restored {got}, saved {saved}")
        rrec, _ = two_chunks("resumed", res)
        # the run's own chunks from its checkpoint on: the resumed one's
        # first takes the same bits (its second may not: the host's shrink
        # counters start again at a resume)
        own = [r for r in recs if r["step0"] >= ckpt_every][:2]
        out["resume"] = {**got, "losses": [r["loss"] for r in rrec],
                         "run_losses": [r["loss"] for r in own]}
        if (rrec[0]["loss"], rrec[0]["psnr"]) != (own[0]["loss"],
                                                  own[0]["psnr"]):
            raise AssertionError(f"resumed chunk {rrec[0]} differs from the "
                                 f"run's own chunk at step {ckpt_every}: "
                                 f"{own[0]}")
        del res

        seg = trainer_for(dataclasses.replace(cfg, march_seg=8))
        seg.resume(kept)
        srec, scounts = two_chunks("march_seg", seg, k4_per_step=2)
        out["march_seg"] = {"launches": scounts,
                            "losses": [r["loss"] for r in srec],
                            "complete_frac": [r["complete_frac"]
                                              for r in srec],
                            "ms_per_step": [r["ms"] / r["steps"]
                                            for r in srec]}
        del seg

        st = trainer_for(cfg, stacked_host=True)
        st.resume(kept)
        strec, _ = two_chunks("stacked host", st)
        out["stacked_host"] = {"losses": [r["loss"] for r in strec],
                               "ms_per_step": [r["ms"] / r["steps"]
                                               for r in strec]}
        del st
        out["k4_path_checks"] = [(r["path"], r["lattice"], r["budget"])
                                 for r in _check_k4_kept(k4)]
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def hash4d_phase(cfg, seed, steps=HASH4D_STEPS):
    """Trainer.run_step on the full-width 4D keyframe field for `steps`
    steps, then one 400x400 frame at 128 samples of the trained field and
    its occupancy grid through ViewerServer."""
    import torch
    from cednerf_torch.datasets.procedural import BallCloudScene
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.utils.bench import HASH4D_FLAGS, orbit_c2w
    from cednerf_torch.viewer.server import ViewerServer

    flags = ModelFlags(**HASH4D_FLAGS)
    field = build_field(cfg, flags, device="cuda", seed=seed)
    n_levels = field.hash_encoder.bspec.n_levels
    trainer = Trainer(field, cfg, flags, BallCloudScene(seed=seed),
                      seed=seed, device="cuda")
    recs, counts = _drive(trainer, cfg, steps, "hash4d")
    if (counts["scatter_add_rows"] != n_levels * steps
            or counts["key_sort"] != n_levels * steps):
        raise AssertionError(f"hash4d: K3 launched {counts['scatter_add_rows']}"
                             f" times and its sort {counts['key_sort']} in "
                             f"{steps} steps, not {n_levels} a step")
    if counts["compact_select"] != steps:
        raise AssertionError(f"hash4d: K4 launched {counts['compact_select']}"
                             f" times in {steps} steps")
    if any(counts[k] for k in ("fused_encode_fwd", "fused_encode_bwd",
                               "interp_fwd", "interp_bwd_fused")):
        raise AssertionError(f"hash4d took a 3D kernel: {counts}")
    summary = _train_summary(recs, cfg, counts, "hash4d_step")

    server = ViewerServer(field, trainer.state.occ, cfg, wh=(400, 400),
                          render_bkgd=(1, 1, 1))
    httpd = server.start(port=0, host="127.0.0.1")
    port = httpd.server_address[1]
    try:
        post_render(port, orbit_c2w(), 0.25, 64, 32, False)    # warm-up
        reset_counts()
        _, wall_ms, n_bytes = post_render(port, orbit_c2w(), 0.5, 400, 128,
                                          False)
        launches, plain = all_counts()
        stats = server.last_frame
    finally:
        httpd.shutdown()
        httpd.server_close()
    if not stats["finite"]:
        raise AssertionError("hash4d frame: non-finite values")
    if any(plain.values()) or any(launches.values()):
        raise AssertionError(f"hash4d frame: launches {launches}, plain "
                             f"versions on CUDA {plain} (its forward is "
                             "plain PyTorch, no kernel)")
    summary["frame"] = {
        "t": 0.5, "width": 400, "max_samples": 128,
        "render_ms": stats["ms"], "http_ms": wall_ms, "png_bytes": n_bytes,
        "chunks": len(stats["passes_per_chunk"]),
        "passes_per_chunk": stats["passes_per_chunk"], "launches": launches}
    log(json.dumps({"hash4d_frame": summary["frame"]}))
    return summary


def _hyper_frame_check(seed):
    """Card vs CPU frame of the shrunken HyperNeRF config (HYPER_REF): a
    32x32 frame through the lattice marcher, budgeted and budgeted=False,
    from fields given the same uniform(+-REF_TABLE_BOUND) tables and the
    card field's 2-level grid; reference_phase's limits, and its check that
    a field with ~0 features moves the frame by more than 5x them. The card
    runs must launch K4 (budgeted) and K5, no plain version."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.rays import pinhole_rays
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, hypernerf_config
    from cednerf_torch.engine.renderer import (eval_chunk_for,
                                               make_eval_render_fn,
                                               render_image)
    from cednerf_torch.ops.occupancy import OccGridState
    from cednerf_torch.utils.bench import (TRAIN_FLAGS, fill_occupancy,
                                           load_uniform_tables, orbit_c2w)

    cfg = dataclasses.replace(hypernerf_config("vrig_3dprinter"), **HYPER_REF)
    flags = ModelFlags(**TRAIN_FLAGS)
    card, cpu, served = (build_field(cfg, flags, device=dev, seed=seed)
                         for dev in ("cuda", "cpu", "cuda"))
    load_uniform_tables([card, cpu], seed, REF_TABLE_BOUND)
    occ = fill_occupancy(card, cfg, seed, "cuda")
    cpu_occ = OccGridState(*(a.cpu() for a in occ))
    w = 32
    K = np.array([[w * 1.1, 0, w / 2], [0, w * 1.1, w / 2], [0, 0, 1]],
                 np.float32)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="xy")
    o, d, _ = pinhole_rays(xx.reshape(-1), yy.reshape(-1), K,
                           np.broadcast_to(orbit_c2w(), (w * w, 3, 4)), True)
    bkgd = np.zeros(3, np.float32)
    rec = {"occupied": occ.binaries.float().mean(dim=(1, 2, 3)).tolist()}
    for budgeted in (True, False):
        outs, launches = [], None
        for f, g in ((card, occ), (cpu, cpu_occ), (served, occ)):
            fn = make_eval_render_fn(f, cfg, s_max=64, budgeted=budgeted)
            if f is card:
                reset_counts()
            outs.append(render_image(f, g, fn, o, d, 0.5, bkgd,
                                     chunk=eval_chunk_for(cfg)))
            if f is card:
                torch.cuda.synchronize()
                launches, plain = all_counts()
                want = {"fused_encode_fwd", "compact_select"} if budgeted \
                    else {"fused_encode_fwd"}
                if ({k for k, v in launches.items() if v} != want
                        or any(plain.values())):
                    raise AssertionError(
                        f"hypernerf frame (budgeted={budgeted}): launches "
                        f"{launches} (want {sorted(want)}), plain {plain}")
                passes = fn.pass_log
        rec["budgeted" if budgeted else "dense"] = {
            "passes": passes,
            "launches": {k: v for k, v in launches.items() if v},
            **_compare_frames(f"hypernerf frame (budgeted={budgeted})",
                              *outs)}
    return rec


def _hyper_step_check(seed):
    """Card vs CPU train step of the shrunken HyperNeRF config (HYPER_REF:
    cone_angle 4e-3, 2 grid levels, alpha_thre 1e-2, near 0.2), packed and
    packed_render=False, from the same weights (tables uniform(-1, 1), the
    density bias raised to 2 so that samples pass alpha_thre), grid (15% of
    each level's cells), BallScene batch and jitter: phase 6's limits."""
    import numpy as np
    from cednerf_torch.datasets.procedural import BallScene
    from cednerf_torch.engine.config import ModelFlags, hypernerf_config
    from cednerf_torch.utils.bench import TRAIN_FLAGS

    cfg = dataclasses.replace(hypernerf_config("vrig_3dprinter"), **HYPER_REF)
    flags = ModelFlags(**TRAIN_FLAGS)
    rng = np.random.default_rng(seed)
    res = cfg.grid_resolution
    bins = rng.uniform(size=(cfg.grid_nlvl, res, res, res)) < 0.15
    batch = BallScene(n_cams=4, wh=32, n_times=4, seed=seed).sample(128)
    jitter = rng.uniform(size=128).astype(np.float32)
    rec = {}
    for name, packed in (("packed", True), ("dense", False)):
        c = dataclasses.replace(cfg, packed_render=packed)
        rec[name] = _ref_step_check(
            f"hypernerf step ({name})",
            _ref_step_runs(c, flags, bins, batch, jitter, seed, ("xla",),
                           density_bias=2.0), ("xla",))
        if not 0.0 < rec[name]["complete_frac"] <= 1.0 \
                or rec[name]["n_valid"] <= 0:
            raise AssertionError(f"hypernerf step ({name}): {rec[name]}")
    return rec


def hypernerf_phase(seed, steps=HYPER_STEPS, k=HYPER_K):
    """The HyperNeRF preset (hypernerf_config("vrig_3dprinter"), -te -ta -f
    -ae -df -d) at full width on one card:

      1. card vs CPU frame of a shrunken config (_hyper_frame_check);
      2. card vs CPU train steps, packed and dense (_hyper_step_check);
      3. K5 and K6 against their plain versions on the full-width field's
         level layout (max resolution 4096: levels 0-1 dense, 2-7 hashed)
         at the step's sample count and a ragged one, at phase 1's and
         phase 2's limits; then one all-cells occupancy update of the 2-level grid, timed, K5 once
         per 65,536 cells; then Trainer.run(steps) over
         MonocularOrbitScene's device sampler, k steps a chunk (the 256-step
         warmup and 64 steps or more after it): finite losses, the last
         chunk's PSNR above the first's, K6 and K4 once a step and K5 once
         a step plus the occupancy probes, nothing else, no plain version;
      4. ViewerServer /render of 400x400 frames at max_samples
         HYPER_SAMPLES through the lattice marcher on the server's default
         black background: finite PNGs, K4 and K5 once per pass and nothing else;
      5. PSNR, SSIM and MS-SSIM of a held-out view (a novel camera angle at
         a training time, the vrig protocol) against its analytic ground
         truth, finite;
      6. K4's result on the first lattice of each (shape, budget) of the
         training and serving runs, bit-exact against its plain version.
    Then a steady step's device time under torch.profiler."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.procedural import BG, MonocularOrbitScene
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, hypernerf_config
    from cednerf_torch.engine.renderer import (eval_chunk_for,
                                               make_eval_render_fn,
                                               render_image)
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.utils import metrics
    from cednerf_torch.utils.bench import (TRAIN_FLAGS, device_ms,
                                           fill_occupancy, orbit_c2w)
    from cednerf_torch.viewer.server import ViewerServer

    t_phase = time.perf_counter()
    secs = {}
    out = {"frame_check": _hyper_frame_check(seed)}
    log(json.dumps({"hypernerf_frame_check": out["frame_check"]}))
    secs["frame_check"] = time.perf_counter() - t_phase
    out["step_check"] = _hyper_step_check(seed)
    log(json.dumps({"hypernerf_step_check": out["step_check"]}))
    secs["step_check"] = time.perf_counter() - t_phase - secs["frame_check"]
    torch.cuda.empty_cache()

    cfg = hypernerf_config("vrig_3dprinter")
    flags = ModelFlags(**TRAIN_FLAGS)
    scene = MonocularOrbitScene(n_frames=32, wh=128, seed=seed)
    field = build_field(cfg, flags, device="cuda", seed=seed)
    n_params = sum(p.numel() for p in field.parameters())
    out["field_mib"] = n_params * 4 / 2 ** 20

    # 3. K5 and K6 on this field's levels, then the 2-level warmup update
    # alone, then training
    t0 = time.perf_counter()
    out["kernel_checks"] = {
        **kernel_phase(field, cfg.sample_budget, 100_003, seed,
                       names=("fused_encode_fwd",), timed=False),
        **backward_kernel_phase(field, cfg.sample_budget, 100_003, seed,
                                names=("fused_encode_bwd",), timed=False)}
    out["kernel_checks"]["level_rows"] = [
        l["rows"] for l in field.hash_encoder.bspec.level_layout()]
    log(json.dumps({"hypernerf_kernel_checks": out["kernel_checks"]}))
    secs["kernel_checks"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ0 = fill_occupancy(field, cfg, seed, "cuda")
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    launches, _ = all_counts()
    cells = cfg.grid_nlvl * cfg.grid_resolution ** 3
    if launches["fused_encode_fwd"] != -(-cells // 2 ** 16):
        raise AssertionError(f"2-level all-cells update: {launches}")
    out["warmup_update"] = {"cells": cells, "ms": warm_ms,
                            "k5_launches": launches["fused_encode_fwd"],
                            "occupied": occ0.binaries.float().mean(
                                dim=(1, 2, 3)).tolist()}
    del occ0
    trainer = Trainer(field, cfg, flags, scene, seed=seed, device="cuda",
                      device_sampler=scene.device_sampler(),
                      steps_per_call=k)
    recs, k4 = [], {}
    _record_chunks(trainer, recs)
    reset_counts()
    t0 = time.perf_counter()
    with _keeping_k4(k4, "hypernerf train"):
        trainer.run(steps, log_every=0)
    counts, plain = all_counts()
    run_s = time.perf_counter() - t0
    _check_step_launches("hypernerf train", counts, plain, cfg, recs)
    if not recs[-1]["psnr"] > recs[0]["psnr"]:
        raise AssertionError(f"hypernerf train: PSNR {recs[0]['psnr']} -> "
                             f"{recs[-1]['psnr']}")
    steady = [r for r in recs if not r["warmup"]]
    if sum(r["steps"] for r in steady) < steps - cfg.occ_warmup_steps:
        raise AssertionError(f"hypernerf train: fewer than "
                             f"{steps - cfg.occ_warmup_steps} steady steps")
    out["train"] = {
        "steps": trainer.step, "chunks": len(recs), "run_s": run_s,
        "launches": counts, "psnr_first": recs[0]["psnr"],
        "psnr_last": recs[-1]["psnr"],
        "median_ms_per_step_warmup": float(np.median(
            [r["ms"] / r["steps"] for r in recs if r["warmup"]])),
        "median_ms_per_step_steady": float(np.median(
            [r["ms"] / r["steps"] for r in steady])),
        "buckets": sorted({r["num_rays"] for r in recs}),
        "last": {x: recs[-1][x] for x in (
            "num_rays", "n_valid", "n_samples", "complete_frac", "loss",
            "psnr")}}
    for r in recs[:1] + recs[15:17] + recs[-1:]:
        log(json.dumps({"hypernerf_chunk": r}))

    # 4. serving through the lattice marcher
    t0 = time.perf_counter()
    t_view = float(scene.times[5])
    server = ViewerServer(field, trainer.state.occ, cfg, wh=(400, 400))
    httpd = server.start(port=0, host="127.0.0.1")
    port = httpd.server_address[1]
    frames = []
    try:
        post_render(port, orbit_c2w(), t_view, 64, 32, False)   # warm-up
        reset_counts()
        with _keeping_k4(k4, "hypernerf serve"):
            for ms in HYPER_SAMPLES:
                before = all_counts()[0]
                _, wall_ms, n_bytes = post_render(port, orbit_c2w(), t_view,
                                                  400, ms, False)
                after = all_counts()[0]
                stats = server.last_frame
                passes = sum(map(sum, stats["passes_per_chunk"]))
                got = {n: after[n] - before[n] for n in after
                       if after[n] - before[n]}
                rec = {"width": 400, "max_samples": ms, "t": t_view,
                       "render_ms": stats["ms"], "http_ms": wall_ms,
                       "png_bytes": n_bytes,
                       "chunks": len(stats["passes_per_chunk"]),
                       "passes": passes,
                       "passes_per_chunk": [p[0] for p in
                                            stats["passes_per_chunk"]],
                       "launches": got}
                log(json.dumps({"hypernerf_frame": rec}))
                if not stats["finite"]:
                    raise AssertionError(f"hypernerf frame {ms}: non-finite")
                if got != {"fused_encode_fwd": passes,
                           "compact_select": passes}:
                    raise AssertionError(f"hypernerf frame {ms}: launches "
                                         f"{got}, passes {passes}")
                frames.append(rec)
        serve_launches, plain = all_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
    if any(plain.values()):
        raise AssertionError(f"hypernerf serving: plain on CUDA {plain}")
    out["frames"] = frames
    out["serve_launches"] = serve_launches
    secs["serve"] = time.perf_counter() - t0

    # 5. a held-out view's metrics
    gt, o, d = scene.eval_view(0.37, t_view)
    fn = make_eval_render_fn(field, cfg)
    rgb, _, _ = render_image(field, trainer.state.occ, fn, o, d, t_view, BG,
                             chunk=eval_chunk_for(cfg))
    ev = {"theta": 0.37, "t": t_view, "wh": scene.wh,
          "psnr": metrics.psnr(rgb, gt).item(),
          "ssim": metrics.ssim(rgb, gt).item(),
          "ms_ssim": metrics.ms_ssim(rgb, gt).item()}
    if not all(np.isfinite(v) for v in ev.values()):
        raise AssertionError(f"hypernerf eval metrics: {ev}")
    out["eval"] = ev
    log(json.dumps({"hypernerf_eval": ev}))

    # 6. K4 on the new lattices
    out["k4_path_checks"] = [(r["path"], r["lattice"], r["budget"])
                             for r in _check_k4_kept(k4)]

    # a steady step's device time (after the counted runs): run_step
    # takes the chunk's step on a host batch; the warm-up call takes the
    # occupancy update of step 336, the two profiled steps none (profiling
    # a whole chunk's ~60,000 launches took ~40 s of host time)
    t0 = time.perf_counter()
    dev_ms, rows, seen = device_ms(trainer.run_step, 2)      # per call
    out["train"]["device_ms_per_step"] = dev_ms
    out["train"]["device_calls_seen"] = seen
    out["train"]["device_top"] = [(n[:60], c / 2, ms / 2)
                                  for n, c, ms in rows[:8]]
    secs["device_ms"] = time.perf_counter() - t0
    secs["train_run"] = run_s
    out["phase_s"] = time.perf_counter() - t_phase
    out["secs"] = secs
    del trainer, field, server
    torch.cuda.empty_cache()
    return out


# the train_real phase (14): a scene in lego's layout (800x800 RGBA, 50
# train and 4 test frames) trained at full width for TRAIN_REAL_STEPS
# steps; the video scene and the HyperNeRF / DyNeRF fixtures train
# SMALL_REAL_STEPS (run while step <= it, so 16 more)
TRAIN_REAL_STEPS, SMALL_REAL_STEPS = 1024, 64
LEGO_WH, LEGO_TRAIN, LEGO_TEST = 800, 50, 4
LEGO_ANGLE_X = 0.6911112070083618            # lego's camera_angle_x
PUBLISHED = ["-te", "-ta", "-f", "-ae", "-df", "-d"]
# the eval PSNR must beat an all-white prediction's by this much
TRAIN_REAL_MARGIN_DB = 3.0


def _ball_image(origins, viewdirs, t, center, radius, bkgd):
    """The port's procedural ball (its colour and drift, ball_center(t))
    centred at `center` with `radius`, analytic along the given rays
    (arrays or tensors [N, 3]; computed on the card), `bkgd` where a ray
    misses: numpy float32 [N, 3]."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.procedural import BALL_COLOR, ball_center

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(
            a, torch.Tensor) else a, dtype=torch.float32, device="cuda")

    o, d = dev(origins), dev(viewdirs)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    oc = o - dev(np.asarray(center, np.float32) + ball_center(t))
    b = (oc * d).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - radius * radius)
    hit = (disc > 0) & (-b - torch.sqrt(disc.clamp(min=0)) > 0)
    return torch.where(hit[:, None], dev(BALL_COLOR),
                       dev(bkgd)).cpu().numpy()


def _write_png(path, rgb_float, wh, alpha=False):
    """The image as an 8-bit PNG whose rows cycle through filters 0-4."""
    import numpy as np
    from cednerf_torch.utils.image import encode_png

    img = (rgb_float.reshape(wh, wh, 3) * 255).astype(np.uint8)
    if alpha:
        img = np.concatenate([img, np.full((wh, wh, 1), 255, np.uint8)], -1)
    with open(path, "wb") as fh:
        fh.write(encode_png(img, filters=(0, 1, 2, 3, 4)))


def _write_dnerf_scene(root, wh, n_train, n_test):
    """A D-NeRF synthetic scene in lego's layout: transforms_{train,test}
    .json (camera_angle_x, per-frame time and OpenGL transform_matrix) and
    RGBA PNGs of the ball at the origin, white background, cameras on
    three rings of radius 3 (test cameras between the train ones)."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.rays import viewmatrix
    from cednerf_torch.engine.sampling import pinhole_rays_device

    d = os.path.join(root, "lego")
    focal = 0.5 * wh / np.tan(0.5 * LEGO_ANGLE_X)
    K = torch.tensor([[focal, 0, wh / 2], [0, focal, wh / 2], [0, 0, 1]],
                     dtype=torch.float32, device="cuda")
    px = torch.arange(wh, dtype=torch.float32, device="cuda")
    y, x = (g.reshape(-1) for g in torch.meshgrid(px, px, indexing="ij"))
    for split, n, off in (("train", n_train, 0.0), ("test", n_test, 0.5)):
        os.makedirs(os.path.join(d, split), exist_ok=True)
        frames = []
        for i in range(n):
            th = 2 * np.pi * (i + off) / n
            pos = np.array([3 * np.cos(th), 3 * np.sin(th),
                            (0.4, 1.0, 1.6)[i % 3]], np.float32)
            c2w = np.eye(4)
            c2w[:3] = viewmatrix(pos, np.array([0.0, 0, 1]), pos)
            t = i / (n - 1)
            o, v = pinhole_rays_device(x, y, K, torch.tensor(
                c2w[:3], dtype=torch.float32, device="cuda").expand(
                    x.shape[0], 3, 4), True)
            _write_png(os.path.join(d, split, f"r_{i:03d}.png"),
                       _ball_image(o, v, t, (0.0, 0.0, 0.0), 0.5,
                                   (1.0, 1.0, 1.0)), wh, alpha=True)
            frames.append({"file_path": f"./{split}/r_{i:03d}", "time": t,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(d, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": LEGO_ANGLE_X, "frames": frames}, f)
    return d


def _focus(ds):
    """Least-squares closest point to every image's central ray."""
    import numpy as np

    A, rhs = np.zeros((3, 3)), np.zeros(3)
    for i in range(len(ds)):
        r = ds.image_rays(i)
        o = np.asarray(r["origins"]).reshape(-1, 3)
        v = np.asarray(r["viewdirs"]).reshape(-1, 3)
        mid = o.shape[0] // 2
        dv = v[mid] / np.linalg.norm(v[mid])
        P = np.eye(3) - np.outer(dv, dv)
        A += P
        rhs += P @ o[mid]
    return np.linalg.solve(A, rhs)


def _paint(datasets, paths, center, radius, wh):
    """Repaint each dataset image (paths[split][i]) with the ball along the
    loader's own rays, on black (the HyperNeRF and DyNeRF backgrounds)."""
    import numpy as np

    for split, ds in datasets.items():
        for i in range(len(ds)):
            r = ds.image_rays(i)
            rgb = _ball_image(np.asarray(r["origins"]).reshape(-1, 3),
                              np.asarray(r["viewdirs"]).reshape(-1, 3),
                              float(r["timestamp"]), center, radius,
                              (0.0, 0.0, 0.0))
            if not (rgb.any(axis=-1)).mean() > 0.02:
                raise AssertionError(f"{paths[split][i]}: the ball is "
                                     "hardly in view")
            _write_png(paths[split][i], rgb, wh)


def _write_hypernerf_scene(root, wh, n_imgs):
    """A HyperNeRF vrig capture (scene.json, metadata.json, dataset.json,
    camera/<id>.json, rgb/2x/<id>.png) of `n_imgs` frames from 2 rig
    cameras (two intrinsics) on a ring; even frames train, odd ones are the
    val split; painted with the ball at the cameras' focus."""
    import numpy as np
    from cednerf_torch.datasets.hypernerf import HyperNeRFDataset

    inner = os.path.join(root, "vrig_chicken", "chicken")
    os.makedirs(os.path.join(inner, "camera"))
    os.makedirs(os.path.join(inner, "rgb", "2x"))
    ids = [f"{i:06d}" for i in range(n_imgs)]
    with open(os.path.join(inner, "scene.json"), "w") as f:
        json.dump({"near": 0.1, "far": 10.0, "scale": 1.0,
                   "center": [0.0, 0.0, 0.0]}, f)
    with open(os.path.join(inner, "metadata.json"), "w") as f:
        json.dump({i: {"time_id": k, "camera_id": (k // 2) % 2,
                       "warp_id": k, "appearance_id": k}
                   for k, i in enumerate(ids)}, f)
    with open(os.path.join(inner, "dataset.json"), "w") as f:
        json.dump({"ids": ids, "train_ids": ids[::2], "val_ids": ids[1::2]},
                  f)
    for k, i in enumerate(ids):
        th = 2 * np.pi * k / n_imgs
        pos = np.array([2.5 * np.cos(th), 2.5 * np.sin(th), 0.5])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        rig = (k // 2) % 2
        cam = {"orientation": np.stack([right, np.cross(fwd, right),
                                        fwd]).tolist(),
               "position": pos.tolist(),
               "focal_length": 2 * wh * (1.2 if rig == 0 else 1.35),
               "principal_point": [wh, wh], "skew": 0.0,
               "pixel_aspect_ratio": 1.0,
               "radial_distortion": [0.01, 0.001, 0.0],
               "tangential_distortion": [0.001, 0.0],
               "image_size": [2 * wh, 2 * wh]}
        with open(os.path.join(inner, "camera", f"{i}.json"), "w") as f:
            json.dump(cam, f)
        _write_png(os.path.join(inner, "rgb", "2x", f"{i}.png"),
                   np.zeros((wh * wh, 3), np.float32), wh)
    kw = dict(factor=2, add_cam=True)
    sets = {"train": HyperNeRFDataset("vrig_chicken", root, "train", **kw),
            "test": HyperNeRFDataset("vrig_chicken", root, "test", **kw)}
    paths = {k: v.image_paths for k, v in sets.items()}
    center = _focus(sets["train"])
    _paint(sets, paths, center, 0.5, wh)
    return center


def _write_dynerf_scene(root, wh, n_cams, n_frames):
    """A DyNeRF (Neural 3D Video) scene: poses_bounds.npy (LLFF poses of
    `n_cams` cameras on an arc converging on the origin) and the
    images_x4_list.json frame manifest ('weight' is the width, as in the
    dataset's converter); camera 0 is the test camera, the others train.
    Painted with the ball at the train cameras' focus."""
    import numpy as np
    from cednerf_torch.datasets.dynerf import DyNeRFDataset

    d = os.path.join(root, "cook_spinach")
    os.makedirs(os.path.join(d, "frames"))
    rows = []
    for c in range(n_cams):
        th = 0.9 * np.pi * (c / max(n_cams - 1, 1) - 0.5)
        p = np.array([3.0 * np.sin(th), 0.6, 3.0 * np.cos(th)])
        back = p / np.linalg.norm(p)
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        down = -np.cross(back, right)
        pose = np.stack([down, right, back, p], axis=1)
        hwf = np.array([[wh * 4], [wh * 4], [wh * 8.0]])
        rows.append(np.concatenate([np.concatenate([pose, hwf], 1).reshape(-1),
                                    [1.0, 10.0]]))
    np.save(os.path.join(d, "poses_bounds.npy"), np.stack(rows))
    manifest = {"scene": "cook_spinach", "videos": []}
    paths = {"train": [], "test": []}
    for c in range(n_cams):
        entries = []
        for j in range(n_frames):
            rel = os.path.join("frames", f"c{c}_f{j}.png")
            _write_png(os.path.join(d, rel),
                       np.zeros((wh * wh, 3), np.float32), wh)
            entries.append({"path": rel, "idx": j, "weight": wh,
                            "height": wh})
            if c:
                paths["train"].append(os.path.join(d, rel))
            elif j % 10 == 0:
                paths["test"].append(os.path.join(d, rel))
        manifest["videos"].append({"video_name": f"cam{c:02d}",
                                   "images": entries})
    with open(os.path.join(d, "images_x4_list.json"), "w") as f:
        json.dump(manifest, f)
    kw = dict(factor=4, sampling="uniform")
    sets = {"train": DyNeRFDataset("cook_spinach", root, "train",
                                   num_rays=64, **kw),
            "test": DyNeRFDataset("cook_spinach", root, "test", **kw)}
    center = _focus(sets["train"])
    o0 = np.asarray(sets["train"].image_rays(0)["origins"]).reshape(-1, 3)[0]
    _paint(sets, paths, center, 0.3 * float(np.linalg.norm(center - o0)), wh)
    return d


def _in_dir(path, fn, *args):
    """fn(*args) with the working directory at `path` (train_real writes its
    PNGs there), restored after."""
    here = os.getcwd()
    os.chdir(path)
    try:
        return fn(*args)
    finally:
        os.chdir(here)


def _check_real_run(label, summary, lattice_eval, need_train=True):
    """A train_real summary's checks: finite outputs, no plain version on
    CUDA, and K5, K6 and K4 launched by the training run; K5 by the
    evaluation, and K4 too where it runs the lattice marcher (cone-angle
    presets; the D-NeRF preset's segment renderer compacts without K4)."""
    log(json.dumps({"train_real_summary": {
        "label": label, **{k: v for k, v in summary.items()
                           if k not in ("eval", "chunks")},
        "eval": {k: v for k, v in summary["eval"].items()
                 if k != "plain_cuda_calls"}}}))
    if not summary["eval"]["finite"]:
        raise AssertionError(f"{label}: non-finite eval output")
    runs = [("eval", summary["eval"], ("fused_encode_fwd",)
             + (("compact_select",) if lattice_eval else ()))]
    if need_train:
        runs.append(("train", summary, ("fused_encode_fwd",
                                        "fused_encode_bwd", "compact_select")))
    for what, rec, names in runs:
        if any(rec["plain_cuda_calls"].values()):
            raise AssertionError(f"{label} {what}: plain versions on CUDA "
                                 f"{rec['plain_cuda_calls']}")
        missing = [n for n in names if not rec["launches"][n]]
        if missing:
            raise AssertionError(f"{label} {what}: {missing} never launched "
                                 f"({rec['launches']})")
        no_probe_kernels(f"{label} {what}", rec["launches"])


def _train_real_cli(args, cwd, module="train_real"):
    """`python -m cednerf_torch.MODULE ARGS` in `cwd` (train_real or
    train_prop_real): (its last-line summary, seconds). Fails on a non-zero
    exit."""
    import subprocess

    env = dict(os.environ)
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("CEDNERF_CFG", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"cednerf_torch.{module}"]
                          + args, cwd=cwd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{module} {args} exited {proc.returncode}:"
                             f"\n{proc.stdout[-6000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])[module], secs


def train_real_phase(seed, scanned_steady_ms):
    """The port's real-data entry point on the card, on scenes written to a
    temporary directory in the datasets' own formats:

      1. a D-NeRF scene in lego's layout (800x800 RGBA, 50 train and 4
         test frames, rows cycling through PNG filters 0-4), the decode
         time of its 50 train frames;
      2. `python -m cednerf_torch.train_real --scene lego --max_steps 1024
         -te -ta -f -ae -df -d` (the full dnerf_config: L8 F4, budget 2^18,
         128^3 grid) as a subprocess: steps a second, warmup and steady ms a
         step (against the scanned phase's procedural run_chunk), K5, K6
         and K4 launched by the training and K5 by the evaluation (its
         segment renderer compacts without K4), no plain version on CUDA, finite outputs, and the mean PSNR over
         the 4 test views at least TRAIN_REAL_MARGIN_DB above an all-white
         prediction's; then a steady step's device ms (two run_steps of a
         Trainer resumed from the run's checkpoint, under torch.profiler);
      3. the same command with --load_model: it loads and does not
         evaluate; train_real.evaluate_checkpoint here gives the same PSNR
         within 1e-4 dB;
      4. a 100x100 scene: SMALL_REAL_STEPS steps, then --load_model
         --render_video in process: all 120 frames written (mp4, or PNG
         frames without an mp4 writer);
      5. K5 and K6 against their plain versions on the full-width DyNeRF
         field's own level layout (dynerf_config: max resolution 8192 over
         the outer +-8 aabb, rows 216, 2744, then 16,384 hashed) at its
         budget of 2^20 samples and at a ragged 100,003, x over the whole
         outer aabb and half of it in the inner +-1 box, at phase 1's and
         2's limits;
      6. the HyperNeRF preset on a vrig fixture (rgb/2x, 2 rig cameras) and
         the DyNeRF preset on an images_x4 fixture (3 train cameras, ISG
         weights computed by the native C++, --isg2ist_step 32,
         --mark_invisible), SMALL_REAL_STEPS steps each in process, their
         launches per kernel (their lattice evaluation launches K5 and K4);
      7. K4's result on the first lattice of each (shape, budget) that the
         in-process runs (4 and 6) made, bit-exact against its plain
         version.
    """
    import shutil
    import tempfile

    import numpy as np
    import torch
    from cednerf_torch import train_real
    from cednerf_torch.datasets.dnerf_synthetic import DNeRFSyntheticDataset
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import (ModelFlags, dnerf_config,
                                             dynerf_config)
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.utils.bench import TRAIN_FLAGS, device_ms
    from cednerf_torch.utils.image import read_png

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_real_")
    out, k4 = {}, {}
    try:
        # 1. the lego-layout scene and its decode time
        t0 = time.perf_counter()
        lego = _write_dnerf_scene(os.path.join(tmp, "dnerf"), LEGO_WH,
                                  LEGO_TRAIN, LEGO_TEST)
        out["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stack = [read_png(os.path.join(lego, "train", f"r_{i:03d}.png"))
                 for i in range(LEGO_TRAIN)]
        out["decode_s"] = time.perf_counter() - t0
        out["decoded"] = [len(stack), *stack[0].shape]
        del stack
        test = DNeRFSyntheticDataset("lego", os.path.dirname(lego), "test")
        white = [float(-10 * np.log10(np.mean(
            (1.0 - test.image_rays(i)["pixels"]) ** 2)))
            for i in range(len(test))]
        out["white_psnr_avg"] = float(np.mean(white))
        log(json.dumps({"train_real_scene": out}))

        # 2. full-width training from disk, as a subprocess
        run = os.path.join(tmp, "run")
        os.makedirs(run)
        ckpt = os.path.join(tmp, "ckpt")
        base = ["--scene", "lego", "--data_root", os.path.dirname(lego),
                "--model_path", ckpt] + PUBLISHED
        s, secs = _train_real_cli(base + ["--max_steps",
                                          str(TRAIN_REAL_STEPS)], run)
        _check_real_run("train_real lego", s, lattice_eval=False)
        psnr = s["eval"]["psnr_avg"]
        if not psnr >= out["white_psnr_avg"] + TRAIN_REAL_MARGIN_DB:
            # the run's per-chunk log, to find where it left the band
            log(json.dumps({"train_real_lego_chunks": s["chunks"]}))
            raise AssertionError(
                f"train_real lego: eval PSNR {psnr} not {TRAIN_REAL_MARGIN_DB}"
                f" dB above all-white {out['white_psnr_avg']}")
        out["train"] = {k: s.get(k) for k in (
            "step", "steps", "train_s", "steps_per_s", "load_s", "warmup_s",
            "steady_ms_per_step", "sampler", "launches")}
        out["train"].update(process_s=secs, eval_psnr=psnr,
                            eval_ms_ssim=s["eval"]["ssim_avg"],
                            eval_psnrs=s["eval"]["psnrs"],
                            chunks=s["chunks"],
                            eval_launches=s["eval"]["launches"],
                            scanned_procedural_steady_ms=scanned_steady_ms)
        # a steady step's device time on this scene's device sampler
        cfg = dnerf_config(TRAIN_REAL_STEPS)
        flags = ModelFlags(**TRAIN_FLAGS)
        ds = DNeRFSyntheticDataset("lego", os.path.dirname(lego), "train",
                                   num_rays=cfg.init_batch_size)
        trainer = Trainer(build_field(cfg, flags, device="cuda", seed=42),
                          cfg, flags, ds, seed=42, device="cuda",
                          device_sampler=ds.device_sampler("cuda"))
        trainer.resume(ckpt)
        dev_ms, rows, seen = device_ms(trainer.run_step, 2)
        out["train"]["device_ms_per_step"] = dev_ms
        out["train"]["device_calls_seen"] = seen
        out["train"]["device_top"] = [(n[:60], c / 2, ms / 2)
                                      for n, c, ms in rows[:6]]
        del trainer, ds
        torch.cuda.empty_cache()
        log(json.dumps({"train_real_lego": out["train"]}))

        # 3. reload: --load_model loads and does not evaluate (as the JAX
        # CLI); the loaded checkpoint, evaluated here through the train
        # branch's evaluation, gives the trained run's PSNR
        for name in ("rgb_test.png", "depth_test.png", "rgb_error.png"):
            os.remove(os.path.join(run, name))
        s2, secs = _train_real_cli(base + ["--load_model"], run)
        if "eval" in s2 or os.path.exists(os.path.join(run,
                                                       "rgb_test.png")):
            raise AssertionError("train_real --load_model evaluated")
        t0 = time.perf_counter()
        ev = _in_dir(run, train_real.evaluate_checkpoint, base)
        _check_real_run("train_real lego reload", {"eval": ev},
                        lattice_eval=False, need_train=False)
        if ev["step"] != s2["step"] or abs(ev["psnr_avg"] - psnr) > 1e-4:
            raise AssertionError(f"train_real reload: step {ev['step']} "
                                 f"PSNR {ev['psnr_avg']} vs {psnr}")
        out["reload"] = {"step": s2["step"], "process_s": secs,
                         "eval_s": time.perf_counter() - t0,
                         "eval_psnr": ev["psnr_avg"],
                         "psnr_diff_db": ev["psnr_avg"] - psnr}
        log(json.dumps({"train_real_reload": out["reload"]}))
        for name in ("rgb_test.png", "depth_test.png", "rgb_error.png"):
            if read_png(os.path.join(run, name)).shape[:2] != (LEGO_WH,
                                                               LEGO_WH):
                raise AssertionError(f"train_real: {name}")

        # 4. a 100x100 scene's video
        t0 = time.perf_counter()
        small = _write_dnerf_scene(os.path.join(tmp, "small"), 100, 8, 2)
        vrun = os.path.join(tmp, "vrun")
        os.makedirs(vrun)
        vbase = ["--scene", "lego", "--data_root", os.path.dirname(small),
                 "--model_path", os.path.join(tmp, "vckpt")] + PUBLISHED
        with _keeping_k4(k4, "train_real video scene"):
            sv = _in_dir(vrun, train_real.main,
                         vbase + ["--max_steps", str(SMALL_REAL_STEPS)])
        _check_real_run("train_real video scene", sv, lattice_eval=False)
        sv2 = _in_dir(vrun, train_real.main,
                      vbase + ["--load_model", "--render_video"])
        frames = sv2["video"]["frames"]
        written = (os.path.exists(os.path.join(vrun, "rgb_render.mp4"))
                   if sv2["video"]["mp4"] else
                   len([f for f in os.listdir(vrun)
                        if f.startswith("rgb_render_")]))
        if frames != 120 or written not in (True, 120):
            raise AssertionError(f"train_real video: {frames} frames, "
                                 f"written {written}")
        out["video"] = {"frames": frames, "mp4": sv2["video"]["mp4"],
                        "step": sv2["step"],
                        "s": time.perf_counter() - t0}
        log(json.dumps({"train_real_video": out["video"]}))

        # 5. K5 and K6 on the DyNeRF field's levels
        t0 = time.perf_counter()
        dcfg = dynerf_config()
        dfield = build_field(dcfg, ModelFlags(**TRAIN_FLAGS), device="cuda",
                             seed=seed)
        inner = (7 / 16, 9 / 16)              # +-1 of the outer +-8 aabb
        out["dynerf_kernel_checks"] = {
            **kernel_phase(dfield, dcfg.sample_budget, 100_003, seed,
                           names=("fused_encode_fwd",), timed=False,
                           inner=inner),
            **backward_kernel_phase(dfield, dcfg.sample_budget, 100_003,
                                    seed, names=("fused_encode_bwd",),
                                    timed=False, inner=inner),
            "level_rows": [l["rows"] for l in
                           dfield.hash_encoder.bspec.level_layout()],
            "s": time.perf_counter() - t0}
        log(json.dumps({"dynerf_kernel_checks":
                        out["dynerf_kernel_checks"]}))
        del dfield
        torch.cuda.empty_cache()

        # 6. the HyperNeRF and DyNeRF presets from disk
        for scene, write, extra in (
                ("vrig_chicken",
                 lambda r: _write_hypernerf_scene(r, 64, 12), []),
                ("cook_spinach", lambda r: _write_dynerf_scene(r, 64, 4, 8),
                 ["--isg2ist_step", "32", "--mark_invisible"])):
            t0 = time.perf_counter()
            root = os.path.join(tmp, scene)
            write(root)
            frun = os.path.join(tmp, scene + "_run")
            os.makedirs(frun)
            with _keeping_k4(k4, f"train_real {scene}"):
                sf = _in_dir(frun, train_real.main, [
                    "--scene", scene, "--data_root", root, "--max_steps",
                    str(SMALL_REAL_STEPS), "--model_path",
                    os.path.join(tmp, scene + "_ckpt")] + PUBLISHED + extra)
            _check_real_run(f"train_real {scene}", sf, lattice_eval=True)
            rec = {k: sf.get(k) for k in ("step", "sampler", "train_s",
                                          "launches")}
            rec.update(eval_psnr=sf["eval"]["psnr_avg"],
                       eval_launches=sf["eval"]["launches"],
                       s=time.perf_counter() - t0)
            if scene == "cook_spinach":
                d = os.path.join(root, "cook_spinach")
                rec["weights"] = sorted(f for f in os.listdir(d)
                                        if f.endswith("_weights_f4.npy"))
                if rec["weights"] != ["isg_weights_f4.npy",
                                      "ist_weights_f4.npy"]:
                    raise AssertionError(f"dynerf weights: {rec['weights']}")
            out[scene] = rec
            log(json.dumps({f"train_real_{scene}": rec}))

        # 7. K4 on the in-process runs' lattices
        out["k4_path_checks"] = [(r["path"], r["lattice"], r["budget"])
                                 for r in _check_k4_kept(k4)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# the secondary-encoder phase: the texture scene's cell-layout run (the
# 256-step warmup and 32 after it; runs while step <= 272, 18 chunks), the
# short runs of the other options (4 warmup chunks), and the remat check's
# batch (one sample a brick row on every level: level 0 has 216 rows)
CELL_STEPS, SHORT_STEPS, REMAT_N = 272, 48, 128


def _cell_offsets(spec):
    """K6c's cell_rows argument: each cell level's first row in the cell
    gradient, -1 for a brick level."""
    offs, off = [], 0
    for lay, cell in zip(spec.level_layout(), spec.cell_levels()):
        offs.append(off if cell else -1)
        off += 27 * lay["rows"] if cell else 0
    return offs


def old_fold_ops(d_cell, n_feat, compute_dtype, accum_bf16):
    """One cell level's fold as the port ran it before fold_cells, for the
    A/B against the kernel (and for the CPU test that the wrapper returns
    what it returned before): plain tensor ops (the casts, a cat with a
    zero slot, the slot gather into [rows, 64, 8, F], one sum over the
    slots, the casts back)."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    if accum_bf16:
        d_cell = d_cell.to(torch.bfloat16)
    rows = d_cell.shape[0] // 27
    d = d_cell.to(compute_dtype).float().view(rows, 216, n_feat)
    d = torch.cat([d, d.new_zeros(rows, 1, n_feat)], dim=1)
    folded = d.index_select(1, ek.fold_index(d.device)).view(
        rows, 64, 8, n_feat).sum(2)
    return folded.to(compute_dtype).float().view(rows, -1)


def _touched_share(d_cell, spans, n_feat):
    """Per cell level (spans: fold spans), the share of its brick rows
    with a nonzero cell sum, as a device tensor."""
    import torch
    return torch.stack([
        (d_cell[c:c + 27 * r].view(r, 27 * 8 * n_feat) != 0).any(1)
        .float().mean() for _, c, r in spans])


def _fold_bf16_steps(got, want, frac):
    """Each folded entry within one bf16 step of want's plus `frac` of
    want's largest entry: (max steps off, max |got - want| / max |want|,
    ok)."""
    import torch
    step = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    diff = (got - want).abs()
    ok = not bool((diff > step + frac * want.abs().max()).any())
    return (diff / step).max().item(), _frac_err(got, want), ok


def cell_backward_kernel_phase(field, n_main, n_ragged, seed, timed=True):
    """K6c and fold_cells against their plain versions on the full-width
    cell-layout field's levels (its spec's cell levels take the per-cell
    target, the others K6's brick target), tables uniform(-8, 8), x
    uniform over the unit cube, at one train step's sample count and at a
    ragged one:
      * K6c launched into zeroed buffers (ek._launch_k6c): the brick
        levels' table gradient and each cell level's cell rows within
        BWD_TABLE_FRAC of that level's largest entry, d_x within
        BWD_DX_FRAC (K6's limits: both sum f32 terms, the kernel in the
        ordered reduce's two levels);
      * fold_cells on those cell rows against its plain version on a copy
        of them: bit for bit, and the rows it read zero after it;
      * the cell layouts' backward, fused_encode_bwd_cell (K6c into the
        resident buffer, then the fold), against the plain pair: the brick
        levels' rows and d_x at K6c's limits, each folded entry within one
        bf16 step of the plain one plus BWD_TABLE_FRAC of the level's
        largest entry (the fold rounds to bf16 sums that K6c added in
        another order), and the resident buffer all zero after.
    With `timed`, on n_main uniform, n_main ray-major and 1,048,576
    uniform samples: K6c's kernel alone, fold_cells, the wrapper that runs
    both, the path they replace (K6c's kernel into torch.zeros buffers,
    then the fold's plain tensor ops as the port ran them before:
    old_fold_ops) and K6 on the same inputs; on n_main uniform also the
    plain versions, the share of the cell levels' brick rows that K6c
    touched, a matmul by the expansion matrix's transpose (the fold's
    library yardstick) and the bounds.
    Returns (K6c's record, fold_cells' record) at n_main."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.utils.bench import cuda_ms

    spec = field.hash_encoder.bspec
    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    offs = _cell_offsets(spec)
    spans = ek._cell_spans(level_rows, offs)
    accum = spec.grad_accum_dtype == "bfloat16"
    L, F = spec.n_levels, spec.n_features
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = ((torch.rand((sum(level_rows), 64 * F), device="cuda",
                         generator=gen) * 2 - 1) * REF_TABLE_BOUND
             ).to(torch.bfloat16)
    brick = torch.repeat_interleave(
        torch.tensor([o < 0 for o in offs]),
        torch.tensor(level_rows)).cuda()
    n_cell = sum(27 * r for _, _, r in spans)

    def k6c_buffers(n):
        """Zeroed buffers for K6c alone: (d_table, d_cell, d_x)."""
        return (torch.zeros((sum(level_rows), 64 * F), device="cuda"),
                torch.zeros((n_cell, 8 * F), device="cuda"),
                torch.empty((n, 3), device="cuda"))

    def old_fold(d_c):
        return [old_fold_ops(d_c[c:c + 27 * r], F, bf16, accum)
                for _, c, r in spans]

    def old_k6c(args):
        """K6c as the port called it before: torch.zeros buffers of the
        whole table gradient and of the cell rows, then the kernel."""
        bufs = k6c_buffers(args[0].shape[0])
        ek._launch_k6c(*args, *bufs)
        return bufs

    def times(args):
        bufs = k6c_buffers(args[0].shape[0])
        t = {"ms": cuda_ms(lambda: ek._launch_k6c(*args, *bufs), 20)}
        t["fold_ms"] = cuda_ms(lambda: ek.fold_cells(
            bufs[1], bufs[0], level_rows, offs, F, bf16, accum), 20)
        t["pair_ms"] = cuda_ms(lambda: ek.fused_encode_bwd_cell(
            *args, bf16, accum), 20)
        _cell_buffers_zero("timing")
        t["old_k6c_ms"] = cuda_ms(lambda: old_k6c(args), 20)
        d_c0 = old_k6c(args)[1]
        t["old_fold_pair_ms"] = cuda_ms(lambda: (
            torch.zeros((n_cell, 8 * F), device="cuda"), old_fold(d_c0)), 20)
        t["old_pair_ms"] = cuda_ms(lambda: old_fold(old_k6c(args)[1]), 20)
        t["k6_same_inputs_ms"] = cuda_ms(lambda: ek.fused_encode_bwd(
            *args[:8]), 20)
        return t

    rec = fold_rec = None
    for n in (n_main, n_ragged):
        x = torch.rand((n, 3), device="cuda", generator=gen)
        g = (torch.randn((n, L * F), device="cuda", generator=gen) * 1e-3
             ).to(torch.bfloat16)
        g[::8] = 0
        rows = _level_rows(x, spec)
        args = (x, g, rows, table, scales, nbs, level_rows, F, offs)
        want = ek.fused_encode_bwd_cell_plain(*args)
        got = k6c_buffers(n)
        ek._launch_k6c(*args, *got)
        torch.cuda.synchronize()
        errs, row0 = [], 0
        for lvl, off in enumerate(offs):
            if off >= 0:
                sl = slice(off, off + 27 * level_rows[lvl])
                errs.append(_frac_err(got[1][sl], want[1][sl]))
            else:
                sl = slice(row0, row0 + level_rows[lvl])
                errs.append(_frac_err(got[0][sl], want[0][sl]))
            row0 += level_rows[lvl]
        err_x = _frac_err(got[2], want[2])
        if max(errs) > BWD_TABLE_FRAC or err_x > BWD_DX_FRAC:
            raise AssertionError(
                f"fused_encode_bwd_cell N={n}: table errors per level {errs}"
                f" (limit {BWD_TABLE_FRAC}), d_x {err_x} (limit "
                f"{BWD_DX_FRAC})")
        touched = _touched_share(got[1], spans, F).tolist()
        max_err = max((got[0][brick] - want[0][brick]).abs().max().item(),
                      (got[1] - want[1]).abs().max().item(),
                      (got[2] - want[2]).abs().max().item())
        want_cell = want[1].clone()
        # the fold: kernel on K6c's cell rows, plain version on a copy
        d_c, d_t = got[1].clone(), got[0].clone()
        ek.fold_cells_plain(d_c, d_t, level_rows, offs, F, bf16, accum)
        ek.fold_cells(got[1], got[0], level_rows, offs, F, bf16, accum)
        torch.cuda.synchronize()
        fold_equal = torch.equal(got[0].view(torch.int32),
                                 d_t.view(torch.int32))
        fold_err = (got[0] - d_t).abs().max().item()
        if not fold_equal or got[1].any():
            raise AssertionError(f"fold_cells N={n}: not bit-equal to its "
                                 f"plain version (max |diff| {fold_err}) or "
                                 "the cell rows it read not zero")
        # the wrapper (K6c into the resident buffer, then the fold)
        # against the plain pair
        _cell_buffers_zero(f"fused_encode_bwd_cell N={n} (before)")
        pair_t, pair_x = ek.fused_encode_bwd_cell(*args, bf16, accum)
        _cell_buffers_zero(f"fused_encode_bwd_cell N={n}")
        ek.fold_cells_plain(want[1], want[0], level_rows, offs, F, bf16,
                            accum)
        pair_errs = (_frac_err(pair_t[brick], want[0][brick]),
                     _frac_err(pair_x, want[2]))
        folded, row0 = [], 0
        for lvl, off in enumerate(offs):
            if off >= 0:
                sl = slice(row0, row0 + level_rows[lvl])
                folded.append(_fold_bf16_steps(pair_t[sl], want[0][sl],
                                               BWD_TABLE_FRAC))
            row0 += level_rows[lvl]
        if (not all(ok for _, _, ok in folded)
                or pair_errs[0] > BWD_TABLE_FRAC
                or pair_errs[1] > BWD_DX_FRAC):
            raise AssertionError(
                f"K6c + fold_cells N={n}: folded rows off by {folded} (bf16 "
                f"steps, fraction of the largest entry; limit one step + "
                f"{BWD_TABLE_FRAC}), brick rows and d_x by {pair_errs}")
        r = {"name": "fused_encode_bwd_cell", "n": n, "levels": L,
             "n_feat": F, "row_layout": spec.row_layout,
             "cell_levels": [o >= 0 for o in offs], "max_abs_err": max_err,
             "table_err_frac_per_level": errs, "dx_err_frac": err_x,
             "pair_brick_dx_err_frac": pair_errs,
             "folded_bf16_steps_per_level": [f[0] for f in folded],
             "folded_err_frac_per_level": [f[1] for f in folded],
             "touched_brick_row_share": touched}
        fr = {"name": "fold_cells", "n_brick_rows": sum(r_ for _, _, r_
                                                          in spans),
              "n_feat": F, "accum_bf16": accum, "bit_equal": fold_equal,
              "max_abs_err": fold_err}
        if n == n_main:
            rec, fold_rec = r, fr
        if n == n_main and timed:
            r.update(times(args))
            fr.update({"ms": r["fold_ms"],
                       "old_fold_pair_ms": r["old_fold_pair_ms"]})
            r["plain_ms"] = cuda_ms(lambda: ek.fused_encode_bwd_cell_plain(
                *args), 3)
            d_c = want_cell.clone()
            fr["plain_ms"] = cuda_ms(lambda: ek.fold_cells_plain(
                d_c, want[0], level_rows, offs, F, bf16, accum), 3)
            # the fold as one product by the expansion matrix's transpose
            # [216F, 64F] (JAX's dot), on the cell rows as they lie
            e_t = torch.zeros((216 * F, 64 * F), device="cuda")
            idx = ek.fold_index("cuda").view(64, 8)
            for c in range(64):
                for s_ in idx[c].tolist():
                    if s_ < 216:
                        for f in range(F):
                            e_t[s_ * F + f, c * F + f] = 1.0
            cells = want_cell.view(-1, 216 * F)
            fr["library_ms"] = cuda_ms(lambda: torch.matmul(cells, e_t), 20)
            fold_b = n_cell * 8 * F * 4 * 2 + fr["n_brick_rows"] * 64 * F * 4
            fr["bound_ms"] = fold_b / HBM_BYTES_PER_S * 1e3
            fr["bound_by"] = "bytes"
            # K6c's bounds: the bytes of its inputs and of what it must
            # write once, the brick levels' table gradient and d_x (the
            # cell levels' rows are the fold's output, the cell rows an
            # intermediate), and the operations; beside them the same with
            # the ordered reduce's keys (algo_bound_ms), and its corner
            # reads plus the reduce's reads of x and g (its second bound)
            in_b = x.numel() * 4 + g.numel() * 2 + rows.numel() * 4 \
                + table.numel() * 2
            brick_rows = sum(r_ for r_, o in zip(level_rows, offs) if o < 0)
            out_b = (brick_rows * 64 * F + n * 3) * 4
            t_bytes = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
            t_ops = n * L * 8 * F * 2 * 2 / F32_FLOPS * 1e3
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            r["algo_bound_ms"] = max(
                t_bytes + _ordered_bytes(n * L, sum(level_rows) + n_cell)
                / HBM_BYTES_PER_S * 1e3, t_ops)
            r["corner_bound_ms"] = (n * L * (4 * 8 * F + 12 + 2 * F)
                                    / HBM_BYTES_PER_S * 1e3)
            for label, xs in (("ray_major", _ray_major_x(n // 64, seed)),
                              ("n_1m", torch.rand((1 << 20, 3),
                                                  device="cuda",
                                                  generator=gen))):
                gs = g if xs.shape[0] == n else (
                    torch.randn((xs.shape[0], L * F), device="cuda",
                                generator=gen) * 1e-3).to(torch.bfloat16)
                r[label] = times((xs, gs, _level_rows(xs, spec), table,
                                  scales, nbs, level_rows, F, offs))
                r[label]["n"] = xs.shape[0]
            del e_t, cells
        log(json.dumps({"kernel_check": r}))
        log(json.dumps({"kernel_check": fr}))
        del want, want_cell, got, d_c, d_t, pair_t, pair_x
        torch.cuda.empty_cache()
    _cell_buffers_zero("cell backward kernel phase")
    return rec, fold_rec


def _unique_row_batch(spec, n, seed):
    """n points of the unit cube no two of which share a brick row on any
    level of `spec` (drawn uniformly, kept greedily): each table address
    of the backward then takes at most one term, so the kernels' table
    gradients do not depend on any summation order."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((1 << 16, 3), device="cuda", generator=gen)
    rows = _level_rows(x, spec).cpu().numpy()
    used = [set() for _ in range(rows.shape[0])]
    keep = []
    for i in range(rows.shape[1]):
        if all(rows[lvl, i] not in used[lvl] for lvl in range(len(used))):
            keep.append(i)
            for lvl in range(len(used)):
                used[lvl].add(rows[lvl, i])
            if len(keep) == n:
                break
    return x[torch.tensor(keep, device="cuda")]


def remat_check(cfg, seed):
    """remat_feats against the run without it, brick_encode alone on the
    full-width field's tables (uniform(-8, 8)), on the K5/K6 route and on
    the K1/K2 route: outputs, every table gradient and d_x equal bit for
    bit, on a batch of one sample a brick row (_unique_row_batch)."""
    import torch
    from cednerf_torch.ops.brick_grid import BrickGridSpec, brick_encode

    base = BrickGridSpec(n_levels=cfg.hash_n_levels,
                         n_features=cfg.hash_n_features,
                         max_res=cfg.hash_dst_resolution,
                         log2_hashmap_size=cfg.log2_hashmap_size,
                         max_table_rows=cfg.max_table_rows)
    x = _unique_row_batch(base, REMAT_N, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tables = {k: ((torch.rand(s, device="cuda", generator=gen) * 2 - 1)
                  * REF_TABLE_BOUND) for k, s in base.param_shapes()}
    cot = torch.randn((x.shape[0], base.output_dim), device="cuda",
                      generator=gen)
    out = {"n": x.shape[0]}
    for route in ("xla", "interp"):
        runs = []
        for remat in (False, True):
            spec = dataclasses.replace(base, interp_impl=route,
                                       remat_feats=remat)
            p = {k: v.clone().requires_grad_() for k, v in tables.items()}
            xr = x.clone().requires_grad_()
            y = brick_encode(xr, p, spec)
            (y.float() * cot).sum().backward()
            runs.append([y.detach(), xr.grad] + [p[k].grad for k in p])
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(*runs)]
        if not all(same):
            raise AssertionError(f"remat_feats on the {route} route: "
                                 f"outputs / d_x / tables equal {same}")
        out[route] = {"bit_identical": True, "tensors": len(same)}
    log(json.dumps({"remat_check": out}))
    return out


def triplane_encoder_check(seed, n=65_536):
    """The full-width tri-plane encoder (dnerf_config: plane_res 1024, F =
    4, 8 levels) on the card against the CPU, bf16, planes uniform(-1, 1),
    x over the unit cube and a little outside it: the output equal bit for
    bit (the same PyTorch ops), d_x within BWD_DX_FRAC of its largest
    entry (f32 sums in another order), each entry of the plane gradient
    within one bf16 step of the CPU's plus BWD_TABLE_FRAC of the largest
    entry (f32 sums in another order, as K6's and K3's table gradients,
    then each rounded to bf16 once)."""
    import torch
    from cednerf_torch.engine.config import dnerf_config
    from cednerf_torch.ops.triplane import TriPlaneSpec, triplane_encode

    cfg = dnerf_config()
    spec = TriPlaneSpec(plane_res=cfg.hash_dst_resolution,
                        n_features=cfg.hash_n_features)
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 3), generator=gen) * 1.1 - 0.05
    planes = torch.rand((spec.total_rows, spec.n_features),
                        generator=gen) * 2 - 1
    cot = torch.randn((n, spec.output_dim), generator=gen)
    res = []
    for dev in ("cpu", "cuda"):
        xt = x.to(dev).detach().requires_grad_()
        p = planes.to(dev).detach().requires_grad_()
        y = triplane_encode(xt, p, spec)
        (y.float() * cot.to(dev)).sum().backward()
        res.append((y.detach().cpu(), xt.grad.cpu(), p.grad.cpu()))
    torch.cuda.synchronize()
    (y0, dx0, dp0), (y1, dx1, dp1) = res
    step = torch.ldexp(torch.ones_like(dp0),
                       torch.frexp(dp0).exponent - 8)     # a bf16 step
    rec = {"n": n, "out_equal": bool(torch.equal(y0, y1)),
           "dx_err_frac": _frac_err(dx1, dx0),
           "planes_err_frac": _frac_err(dp1, dp0),
           "planes_max_bf16_steps": ((dp1 - dp0).abs() / step).max().item(),
           "planes_differ": int((dp1 != dp0).sum())}
    bad = (dp1 - dp0).abs() > step + BWD_TABLE_FRAC * dp0.abs().max()
    if (not rec["out_equal"] or rec["dx_err_frac"] > BWD_DX_FRAC
            or bool(bad.any())):
        raise AssertionError(f"tri-plane encoder card vs CPU: {rec}")
    log(json.dumps({"triplane_encoder_check": rec}))
    return rec


def _short_run(label, cfg, flags, scene, seed, steps, encoders, bwd,
               encoder_impl="brick", k3_per_step=0):
    """Trainer.run(steps) through run_chunk on the scene's device sampler
    (16 steps a chunk), counted: finite losses, the last chunk's PSNR above
    the first's, the launches that _check_step_launches expects."""
    import torch
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.train import Trainer

    trainer = Trainer(build_field(cfg, flags, device="cuda", seed=seed,
                                  encoder_impl=encoder_impl), cfg, flags,
                      scene, seed=seed, device="cuda",
                      device_sampler=scene.device_sampler(),
                      steps_per_call=16)
    recs = []
    _record_chunks(trainer, recs)
    reset_counts()
    t0 = time.perf_counter()
    trainer.run(steps, log_every=0)
    counts, plain = all_counts()
    run_s = time.perf_counter() - t0
    _check_step_launches(label, counts, plain, cfg, recs, bwd=bwd,
                         encoders=encoders, k3_per_step=k3_per_step)
    if not recs[-1]["psnr"] > recs[0]["psnr"]:
        raise AssertionError(f"{label}: PSNR {recs[0]['psnr']} -> "
                             f"{recs[-1]['psnr']}")
    out = {"steps": trainer.step, "chunks": len(recs), "run_s": run_s,
           "psnr_first": recs[0]["psnr"], "psnr_last": recs[-1]["psnr"],
           "psnr_by_chunk": [round(r["psnr"], 3) for r in recs],
           "ms_per_step_last": recs[-1]["ms"] / recs[-1]["steps"],
           "launches": counts}
    log(json.dumps({label: out}))
    return out, trainer


def _cell_buffers_zero(label):
    """Fails unless every resident cell buffer (ek.cell_buffer) is all
    zero."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    torch.cuda.synchronize()
    if any(buf.any() for buf in ek.cell_buffers()):
        raise AssertionError(f"{label}: the resident cell buffer is not all "
                             "zero")


def _cell_step_readings(trainer, spec):
    """A cell-layout trainer's steady chunk: its device ms and kernels a
    step and K6c's and fold_cells' share of it (profiler, one chunk after
    a warm one), then, over one more chunk, the share of each cell level's
    brick rows that K6c touched: the rows of the samples whose cotangent
    on that level is not all zero (the samples K6c adds), read by a hook
    on the encoder's output."""
    import torch
    from cednerf_torch.utils.bench import device_ms

    k = trainer.steps_per_call
    dev, rows, seen = device_ms(trainer.run_chunk, 1)
    out = {"device_ms_per_step": dev / k, "device_calls_seen": seen,
           "kernels_per_step": sum(calls for _, calls, _ in rows) / k,
           "k6c_device_ms_per_step": sum(
               ms for name, _, ms in rows if "encode_bwd_kernel" in name) / k,
           "fold_device_ms_per_step": sum(
               ms for name, _, ms in rows if "fold_cells_kernel" in name) / k}
    level_rows = [l["rows"] for l in spec.level_layout()]
    cells = [lvl for lvl, c in enumerate(spec.cell_levels()) if c]
    F, shares = spec.n_features, []

    def touched(x, g):
        brick = _level_rows(x, spec)
        hit = []
        for lvl in cells:
            live = (g[:, lvl * F:(lvl + 1) * F] != 0).any(1).float()
            seen = torch.zeros(level_rows[lvl], device=x.device)
            seen.index_add_(0, brick[lvl].long(), live)
            hit.append((seen > 0).float().mean())
        shares.append(torch.stack(hit))

    def on_forward(module, args, enc):
        if enc.requires_grad:
            x = args[0].detach()
            enc.register_hook(lambda g: touched(x, g))

    handle = trainer.state.field.hash_encoder.register_forward_hook(
        on_forward)
    try:
        trainer.run_chunk()
    finally:
        handle.remove()
    out["touched_brick_row_share"] = torch.stack(shares).mean(0).tolist()
    out["touched_steps"] = len(shares)
    _cell_buffers_zero("cell step readings")
    return out


def secondary_phase(seed):
    """Phase 15, the secondary encoders and row layouts at the full width
    of dnerf_config (-te -ta -f -ae -df -d):
      1. row_layout "cell" with fine_table_rows 65536 (the JAX bench
         default: levels 3-4 cell, 5-7 brick): K5, K6c and fold_cells
         against their plain versions at 262,144 samples and a ragged
         100,003 (phase 1's and 2's limits; the fold bit for bit), timed
         (cell_backward_kernel_phase), K6c and the fold once more at
         262,144 for "cellz" and "cellfused"; the reference step card vs
         CPU for the cell layout (its CPU side rounds and folds), 3D and
         hash4d (K3 into the cell rows), through fold_cells, at phase 6's
         limits; Trainer.run(CELL_STEPS) on TexturedCloudScene's device
         sampler past the 256-step warmup: finite losses, rising PSNR, K6c
         and fold_cells once a step, K5 once a step plus the probes, K4
         once a step, no K6; the resident cell buffers (K6c's, and K3's
         on the 4D route) all zero after each of these, then freed; one
         chunk's device ms and the touched brick-row share;
      2. hash4motion: K5 and K6 against their plain versions on the motion
         grid's own levels (L8 F2, 16 -> 2048: levels 0-2 dense), then a
         short run (K5 and K6 twice a step);
      3. --grid_type triplane and encoder_impl "gather": the reference step
         card vs CPU each (the tri-plane's with every module in f32: in
         bf16 its 137-wide MLP input carries the card's and the CPU's
         GEMM roundings past 1%, read and logged; its bf16 encoder is held
         card vs CPU at full width by triplane_encoder_check), a short run
         each (K4 alone), and for the tri-plane one 256x256 frame (2 seg
         passes of 2,097,152 samples) with its peak memory;
      4. remat_feats: remat_check."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.procedural import TexturedCloudScene
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.engine.renderer import (eval_chunk_for,
                                               make_eval_render_fn,
                                               render_image)
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.utils.bench import TRAIN_FLAGS
    from cednerf_torch.utils.metrics import psnr

    t_phase = time.perf_counter()
    flags = ModelFlags(**TRAIN_FLAGS)
    out, kern = {}, {}
    cell_cfg = dataclasses.replace(dnerf_config(), row_layout="cell",
                                   fine_table_rows=65536)
    field = build_field(cell_cfg, flags, device="cuda", seed=seed)
    spec = field.hash_encoder.bspec
    out["cell_levels"] = spec.cell_levels()
    kern.update(kernel_phase(field, cell_cfg.sample_budget, 100_003, seed,
                             names=("fused_encode_fwd",), timed=False))
    kern["fused_encode_bwd_cell"], kern["fold_cells"] = \
        cell_backward_kernel_phase(field, cell_cfg.sample_budget, 100_003,
                                   seed)
    for layout in ("cellz", "cellfused"):
        f = build_field(dataclasses.replace(cell_cfg, row_layout=layout),
                        flags, device="cuda", seed=seed)
        out[layout] = cell_backward_kernel_phase(f, cell_cfg.sample_budget,
                                                 100_003, seed, timed=False)
        del f
    del field
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed)
    ref_cfg = dataclasses.replace(dnerf_config(), **SMALL)
    bins = rng.uniform(size=(1,) + (ref_cfg.grid_resolution,) * 3) < 0.3
    from cednerf_torch.datasets.procedural import BallScene
    batch = BallScene(n_cams=4, wh=32, n_times=4, seed=seed).sample(128)
    jitter = rng.uniform(size=128).astype(np.float32)
    out["reference_steps"] = {}
    tri = dict(grid_type="triplane")
    for label, cfg_kw, flag_kw, impl, dtype in (
            ("cell", dict(row_layout="cell"), {}, "brick", None),
            ("hash4d_cell", dict(row_layout="cell"),
             dict(grid_type="hash4d"), "brick", None),
            ("triplane_f32", {}, tri, "brick", torch.float32),
            ("gather", {}, {}, "gather", None)):
        c = dataclasses.replace(ref_cfg, **cfg_kw)
        fl = ModelFlags(**TRAIN_FLAGS, **flag_kw)
        reset_counts()
        out["reference_steps"][label] = _ref_step_check(
            f"reference step {label}", _ref_step_runs(
                c, fl, bins, batch, jitter, seed, ("xla",),
                encoder_impl=impl, compute_dtype=dtype), ("xla",))
        if "cell" in label:
            # the card's backward went through fold_cells (3D: once, after
            # K6c; 4D: once a cell level, after K3) and left the cell buffers
            # all zero
            counts, _ = all_counts()
            out["reference_steps"][label]["launches"] = {
                k: counts[k] for k in ("fused_encode_bwd_cell", "fold_cells",
                                       "scatter_add_rows")}
            _cell_buffers_zero(f"reference step {label}")
            if not counts["fold_cells"]:
                raise AssertionError(f"reference step {label}: fold_cells "
                                     f"was not launched: {counts}")
    out["reference_steps"]["triplane_bf16_reading"] = triplane_bf16_steps(
        seed)
    log(json.dumps({"secondary_reference_steps": out["reference_steps"]}))
    out["triplane_encoder_check"] = triplane_encoder_check(seed)

    scene = TexturedCloudScene(seed=seed)
    out["train_cell_texture"], tr = _short_run(
        "train_cell_texture", cell_cfg, flags, scene, seed, CELL_STEPS, 1,
        "fused_encode_bwd_cell")
    _cell_buffers_zero("train_cell_texture")
    out["train_cell_texture"].update(_cell_step_readings(tr, spec))
    log(json.dumps({"train_cell_texture_step": {
        k: out["train_cell_texture"][k] for k in (
            "device_ms_per_step", "kernels_per_step",
            "k6c_device_ms_per_step",
            "fold_device_ms_per_step", "touched_brick_row_share")}}))
    del tr
    # the cell layouts are done: free their resident buffers, which would
    # count toward the later peak-memory readings
    ek.release_cell_buffers()
    torch.cuda.empty_cache()

    h4m = ModelFlags(**TRAIN_FLAGS, hash4motion=True)
    cfg = dnerf_config()
    field = build_field(cfg, h4m, device="cuda", seed=seed)
    mg = field.motion_grid
    kern["motion_grid_fwd"] = kernel_phase(
        field, cfg.sample_budget, 100_003, seed, names=("fused_encode_fwd",),
        encoder=mg)["fused_encode_fwd"]
    kern["motion_grid_bwd"] = backward_kernel_phase(
        field, cfg.sample_budget, 100_003, seed, names=("fused_encode_bwd",),
        encoder=mg)["fused_encode_bwd"]
    out["motion_grid_levels"] = [
        (l["rows"], l["hashed"]) for l in mg.bspec.level_layout()]
    del field
    out["train_hash4motion"], tr = _short_run(
        "train_hash4motion", cfg, h4m, scene, seed, SHORT_STEPS, 2,
        "fused_encode_bwd")
    del tr
    torch.cuda.empty_cache()

    tri = ModelFlags(**TRAIN_FLAGS, grid_type="triplane")
    out["train_triplane"], tr = _short_run(
        "train_triplane", cfg, tri, scene, seed, SHORT_STEPS, 0,
        "fused_encode_bwd", k3_per_step=1)
    # one frame of 2 full seg passes (256x256 rays, 64 samples a ray)
    big = TexturedCloudScene(wh=256, seed=seed)
    gt, origins, viewdirs = big.eval_view(theta=0.33 * np.pi, t=0.43)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rgb, _, depth = render_image(tr.state.field, tr.state.occ,
                                 make_eval_render_fn(tr.state.field, cfg),
                                 origins, viewdirs, 0.43,
                                 np.ones(3, np.float32),
                                 chunk=eval_chunk_for(cfg))
    if not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
        raise AssertionError("triplane frame: non-finite values")
    out["train_triplane"]["frame"] = {
        "wh": 256, "chunk": eval_chunk_for(cfg),
        "ms": (time.perf_counter() - t0) * 1e3,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "psnr": psnr(rgb, gt).item()}
    log(json.dumps({"triplane_frame": out["train_triplane"]["frame"]}))
    del tr
    torch.cuda.empty_cache()

    out["train_gather"], tr = _short_run(
        "train_gather", cfg, flags, scene, seed, SHORT_STEPS, 0,
        "fused_encode_bwd", encoder_impl="gather")
    del tr
    torch.cuda.empty_cache()

    out["remat"] = remat_check(cfg, seed)
    out["phase_s"] = time.perf_counter() - t_phase
    return out, kern


# the proposal phase (16): the D-NeRF family's PropTrainer run (16-step
# chunks while step < 256), the HyperNeRF family's 64 steps, and the CLI's
# short run from disk (32 steps on a 100x100 lego-layout scene)
PROP_STEPS, PROP_K, PROP_HYPER_STEPS, PROP_REAL_STEPS = 256, 16, 64, 32
PROP_RAYS = 8192                     # train_prop_real's --num_rays default
PROP_FLAGS = dict(use_time_embedding=True, use_time_attenuation=True,
                  use_feat_predict=True)          # -te -ta -f (README)
PROP_PUBLISHED = ["-te", "-ta", "-f"]


def triplane_bf16_steps(seed):
    """The tri-plane reference step of phase 15 (phase 6's shrunken config,
    its grid, batch and jitter drawn as secondary_phase draws them) card vs
    CPU in bf16, the training dtype, three ways: every module in bf16, the
    encoder alone in bf16 (the MLPs in f32), the MLPs alone in bf16 (the
    encoder in f32). Each one's loss and worst gradient error against the
    CPU; the all-bf16 step held to TRIPLANE_BF16_GRAD_REL and
    STEP_LOSS_RTOL."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.procedural import BallScene
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.utils.bench import TRAIN_FLAGS

    rng = np.random.default_rng(seed)
    ref_cfg = dataclasses.replace(dnerf_config(), **SMALL)
    bins = rng.uniform(size=(1,) + (ref_cfg.grid_resolution,) * 3) < 0.3
    batch = BallScene(n_cams=4, wh=32, n_times=4, seed=seed).sample(128)
    jitter = rng.uniform(size=128).astype(np.float32)
    flags = ModelFlags(**TRAIN_FLAGS, grid_type="triplane")
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    for label, dtype in (("bf16", None),
                         ("encoder_bf16", {"encoder": bf16, "mlp": f32}),
                         ("mlp_bf16", {"encoder": f32, "mlp": bf16})):
        runs = _ref_step_runs(ref_cfg, flags, bins, batch, jitter, seed,
                              ("xla",), compute_dtype=dtype)
        g0, g1 = runs["plain"][2], runs["xla"][2]
        rels = {n: ((g1[n] - g0[n]).norm() / g0[n].norm()).item()
                for n in g0 if g0[n].norm() > 0}
        worst = max(rels, key=rels.get)
        out[label] = {
            "loss_rel_err": abs(runs["xla"][0] - runs["plain"][0])
            / runs["plain"][0], "worst_grad": worst,
            "worst_grad_rel_err": rels[worst],
            "grad_rel_err": rels}
    rec = out["bf16"]
    if (rec["worst_grad_rel_err"] > TRIPLANE_BF16_GRAD_REL
            or rec["loss_rel_err"] > STEP_LOSS_RTOL):
        raise AssertionError(f"tri-plane bf16 step: {rec}")
    log(json.dumps({"triplane_bf16_steps": {
        k: {x: v[x] for x in ("loss_rel_err", "worst_grad",
                              "worst_grad_rel_err")}
        for k, v in out.items()}}))
    return out


def _contracted_draw(aabb):
    """draw(n, gen) for kernel_phase: an unbounded scene's proposal inputs,
    positions in random directions at distances uniform in disparity
    (1 / U, U in (1e-4, 1], as lindisp samples a ray), contracted by
    contract_to_unisphere: the far ones pile up in the outer shell."""
    def draw(n, gen):
        import torch
        from cednerf_torch.models.field import contract_to_unisphere
        a = torch.tensor(aabb, dtype=torch.float32, device="cuda")
        d = torch.randn((n, 3), device="cuda", generator=gen)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        r = 1.0 / (1e-4 + (1.0 - 1e-4) * torch.rand(
            (n, 1), device="cuda", generator=gen))
        return contract_to_unisphere(d * r, a[:3], a[3:]).contiguous()
    return draw


def _prop_kernel_checks(seed):
    """K5 and K6 against their plain versions at the proposal fields'
    layouts (L5 F2, 2^17): 16 -> 128 (D-NeRF, bounded: dense levels 0-2,
    hashed 3-4) at 1,048,576 points (8,192 rays x 128 samples) and 16 ->
    256 (HyperNeRF's second net, unbounded) at 2,097,152 (8,192 x 256),
    each on uniform and on contracted inputs, plus a ragged 100,003;
    phase 1's and 2's limits; the first input of each layout timed."""
    import torch
    from cednerf_torch.engine.config import dnerf_config
    from cednerf_torch.models.field import NGPDensityField

    aabb = dnerf_config().aabb
    out = {}
    for res, n, unbounded in ((128, 1_048_576, False),
                              (256, 2_097_152, True)):
        net = NGPDensityField(aabb=aabb, unbounded=unbounded,
                              max_resolution=res).reset_parameters(
            torch.Generator().manual_seed(seed)).cuda()
        draws = (("uniform", None), ("contracted", _contracted_draw(aabb)))
        if unbounded:
            draws = draws[::-1]
        for i, (label, draw) in enumerate(draws):
            key = f"prop_{res}_{label}"
            fwd = kernel_phase(net, n, 100_003, seed,
                               names=("fused_encode_fwd",), timed=i == 0,
                               encoder=net.grid, draw=draw)
            bwd = backward_kernel_phase(net, n, 100_003, seed,
                                        names=("fused_encode_bwd",),
                                        timed=i == 0, encoder=net.grid,
                                        draw=draw)
            out[key] = {"fused_encode_fwd": fwd["fused_encode_fwd"],
                        "fused_encode_bwd": bwd["fused_encode_bwd"],
                        "level_rows": [l["rows"] for l in
                                       net.grid.bspec.level_layout()]}
        del net
        torch.cuda.empty_cache()
    return out


def _prop_reference_step(seed):
    """One prop step of the shrunken config (SMALL's field, the D-NeRF
    PropConfig) on the card and on the CPU from the same weights (the
    field's tables uniform(-1, 1); the proposal field at its init, its
    MLP's bias 2), batch and jitters, at a step past the anneal: n_samples
    exact, the loss within STEP_LOSS_RTOL and every gradient of the field
    and the proposal field within STEP_GRAD_REL of its norm (phase 6's
    limits)."""
    import numpy as np
    import torch
    from cednerf_torch.datasets.procedural import BallScene
    from cednerf_torch.engine import train_prop as tp
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.ops.proposal import draw_jitter
    from cednerf_torch.utils.bench import load_uniform_tables

    cfg = dataclasses.replace(dnerf_config(), **SMALL)
    pcfg = tp.PropConfig.for_family("dnerf")
    flags = ModelFlags(**PROP_FLAGS)
    batch = BallScene(n_cams=4, wh=32, n_times=4, seed=seed).sample(128)
    gen = torch.Generator().manual_seed(seed)
    jitters = [draw_jitter(128, n, gen, "cpu") for n in
               list(pcfg.prop_samples) + [pcfg.n_final]]
    runs = {}
    for dev in ("cpu", "cuda"):
        field = build_field(cfg, flags, device=dev, seed=seed)
        load_uniform_tables([field], seed, 1.0)
        props = tp.build_prop_networks(cfg, pcfg, device=dev, seed=seed)
        with torch.no_grad():
            for p in props:
                p.mlp.out.bias[0] = 2.0
        state = tp.create_prop_train_state(field, props, cfg, pcfg,
                                           device=dev)
        loss, aux = tp._make_prop_loss_fn(field, cfg, flags, pcfg)(
            state, {k: torch.as_tensor(np.asarray(v)).to(dev)
                    for k, v in batch.items()},
            torch.tensor(pcfg.anneal_steps + 13, device=dev),
            jitters=[j.to(dev) for j in jitters])
        grads = {f"{i}.{n}": q.grad.detach().float().cpu()
                 for i, m in enumerate(state.modules())
                 for n, q in m.named_parameters()}
        runs[dev] = (loss.item(), aux["n_samples"].item(), grads)
    (l0, n0, g0), (l1, n1, g1) = runs["cpu"], runs["cuda"]
    rels = {n: ((g1[n] - g0[n]).norm() / g0[n].norm()).item()
            for n in g0 if g0[n].norm() > 0}
    worst = max(rels, key=rels.get)
    rec = {"cpu_loss": l0, "loss": l1, "loss_rel_err": abs(l1 - l0) / l0,
           "n_samples": n1, "worst_grad": worst,
           "worst_grad_rel_err": rels[worst],
           "prop_grad_rel_err": max(v for k, v in rels.items()
                                    if k.startswith("1."))}
    if n1 != n0 or rec["loss_rel_err"] > STEP_LOSS_RTOL \
            or rels[worst] > STEP_GRAD_REL:
        raise AssertionError(f"prop reference step: {rec}")
    log(json.dumps({"prop_reference_step": rec}))
    return rec


def _prop_frame(trainer, cfg, pcfg, view, t):
    """One eval frame of the trainer's state through
    make_prop_eval_render_fn with its occupancy grid: (rgb, opacity, depth,
    ms, launches)."""
    import numpy as np
    import torch
    from cednerf_torch.engine.renderer import render_image
    from cednerf_torch.engine.train_prop import make_prop_eval_render_fn

    fn = make_prop_eval_render_fn(trainer.state.field, trainer.state.props,
                                  cfg, pcfg)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, opac, depth = render_image(trainer.state.field, trainer.occ, fn,
                                    view[1], view[2], t,
                                    np.ones(3, np.float32),
                                    chunk=cfg.eval_chunk)
    ms = (time.perf_counter() - t0) * 1e3
    counts, plain = all_counts()
    if any(plain.values()) or not counts["fused_encode_fwd"]:
        raise AssertionError(f"prop eval frame: launches {counts}, plain "
                             f"{plain}")
    if not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
        raise AssertionError("prop eval frame: non-finite values")
    return rgb, opac, depth, ms, counts


PROP_PROFILE_STEPS = 2     # steps of the profiled loop after each run


def _prop_run(label, trainer, steps, sync_check=False):
    """Train `trainer` for `steps` steps in chunks, counted: per chunk its
    metrics and host ms; with `sync_check`, one chunk dispatched under
    set_sync_debug_mode("error") and one run_chunk whose host syncs are
    counted (must be 1, the metrics read). Fails on a non-finite loss or a
    plain version on CUDA; K6 must run once a step per field and proposal
    field, K5 at least as often, nothing but K5 and K6. Then, outside the
    counts, PROP_PROFILE_STEPS more steps of the same loop under
    torch.profiler (device ms a step; few, because the profiler reads its
    trace back on the host after the run)."""
    import numpy as np
    import torch
    from cednerf_torch.engine.train_prop import make_prop_train_loop
    from cednerf_torch.utils.bench import device_ms, sync_calls

    chunks = steps // trainer.steps_per_call
    recs = []
    reset_counts()
    for _ in range(chunks - (2 if sync_check else 0)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.run_chunk()
        torch.cuda.synchronize()
        m["ms"] = (time.perf_counter() - t0) * 1e3
        if not np.isfinite(m["loss"]):
            raise AssertionError(f"{label} step {trainer.step}: loss "
                                 f"{m['loss']}")
        recs.append(m)
    out = {}
    if sync_check:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = trainer.dispatch_chunk()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not np.isfinite(metrics.cpu().numpy()[:, 0]).all():
            raise AssertionError(f"{label}: sync-checked chunk {metrics}")
        m, syncs = sync_calls(trainer.run_chunk)
        if len(syncs) != 1 or not np.isfinite(m["loss"]):
            raise AssertionError(f"{label} run_chunk: {len(syncs)} host "
                                 f"syncs (want 1): {syncs}")
        out["host_syncs_per_chunk"] = len(syncs)
    counts, plain = all_counts()
    n_mods = 1 + len(trainer.props)
    if any(plain.values()):
        raise AssertionError(f"{label}: plain versions on CUDA {plain}")
    others = {k: v for k, v in counts.items()
              if v and k not in ("fused_encode_fwd", "fused_encode_bwd",
                                 "table_reduce", "key_sort")}
    if (counts["fused_encode_bwd"] != n_mods * steps
            or counts["table_reduce"] != n_mods * steps
            or counts["key_sort"] != n_mods * steps
            or counts["fused_encode_fwd"] < n_mods * steps or others):
        raise AssertionError(f"{label}: launches {counts} over {steps} "
                             f"steps of {n_mods} encoders")
    k = PROP_PROFILE_STEPS
    t0 = time.perf_counter()
    loop = make_prop_train_loop(trainer.field, trainer.props, trainer.cfg,
                                trainer.flags, trainer.pcfg, trainer.n_rays,
                                trainer.device_sampler[1], k)
    dev, rows, seen = device_ms(lambda: loop(trainer.state,
                                             trainer.device_sampler[0],
                                             trainer.generator,
                                             trainer.step), 1)
    ms = [r["ms"] / r["steps"] for r in recs]
    out.update(device_ms_per_step=dev / k, device_calls_seen=seen,
               profile_s=time.perf_counter() - t0,
               device_top=[(n[:60], c / k, t / k) for n, c, t in rows[:8]],
               steps=trainer.step, chunks=chunks,
               psnr_by_chunk=[round(r["psnr"], 3) for r in recs],
               psnr_first=recs[0]["psnr"], psnr_last=recs[-1]["psnr"],
               loss_last=recs[-1]["loss"],
               host_ms_per_step_median=float(np.median(ms[1:] or ms)),
               host_ms_per_step_first_chunk=ms[0],
               n_samples_per_step=recs[-1]["n_samples"],
               launches=counts,
               launches_per_step={k: v / steps for k, v in counts.items()
                                  if v})
    log(json.dumps({label: out}))
    return out


def proposal_phase(seed):
    """Phase 16, the proposal path (engine/train_prop.py) at the full width
    of dnerf_config (L8 F4, 2^21) with -te -ta -f:
      1. _prop_kernel_checks: K5 and K6 at the proposal fields' layouts;
      2. _prop_reference_step: one prop step card vs CPU;
      3. the D-NeRF family (PropConfig.for_family("dnerf"): one bounded
         128-resolution net, 128 + 64 samples a ray, the prop entry point's
         density clamp) on TexturedCloudScene's device sampler, PROP_RAYS
         rays, PROP_STEPS steps in PROP_K-step chunks (_prop_run with the
         sync checks, then PROP_PROFILE_STEPS profiled steps): the last
         timed chunk's PSNR above the first's;
      4. one 200x200 eval frame with occupancy culling through
         make_prop_eval_render_fn; save_prop_checkpoint, a fresh state
         loaded by load_prop_checkpoint renders the frame again: PSNR
         within 1e-4 dB, bit-equality reported;
      5. the HyperNeRF family (two unbounded lindisp nets, 128 / 256
         resolution, 256 + 96 + 48 samples) on MonocularOrbitScene,
         PROP_HYPER_STEPS steps (then PROP_PROFILE_STEPS profiled):
         finite;
      6. `python -m cednerf_torch.train_prop_real` as a subprocess on a
         100x100 lego-layout scene (8 train, 2 test frames): PROP_REAL_STEPS
         steps (K5 and K6 launched, K5 by the evaluation, no plain version
         on CUDA, finite), then its main() in this process with
         --load_model --render_video: no evaluation, 120 frames."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from cednerf_torch import train_prop_real
    from cednerf_torch.datasets.procedural import (MonocularOrbitScene,
                                                   TexturedCloudScene)
    from cednerf_torch.engine import train_prop as tp
    from cednerf_torch.engine.checkpoint import (load_prop_checkpoint,
                                                 save_prop_checkpoint)
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import (ModelFlags, dnerf_config,
                                             hypernerf_config)
    from cednerf_torch.utils.metrics import psnr

    t_phase = time.perf_counter()
    out = {"kernel_checks": _prop_kernel_checks(seed)}
    out["reference_step"] = _prop_reference_step(seed)
    out["checks_s"] = time.perf_counter() - t_phase
    flags = ModelFlags(**PROP_FLAGS)

    def trainer_for(cfg, pcfg, scene, field_seed):
        field = build_field(cfg, flags, device="cuda", seed=field_seed)
        props = tp.build_prop_networks(cfg, pcfg, device="cuda",
                                       seed=field_seed)
        for mod in (field,) + props:          # the entry point's clamp
            mod.density_clamp = pcfg.density_clamp
        return tp.PropTrainer(field, props, cfg, flags, pcfg,
                              scene.device_sampler(), n_rays=PROP_RAYS,
                              seed=seed, steps_per_call=PROP_K,
                              dataset=scene)

    # 3. the D-NeRF family
    cfg = dnerf_config(PROP_STEPS)
    pcfg = tp.PropConfig.for_family("dnerf")
    scene = TexturedCloudScene(seed=seed)
    trainer = trainer_for(cfg, pcfg, scene, seed)
    t0 = time.perf_counter()
    out["train"] = _prop_run("train_prop", trainer, PROP_STEPS,
                             sync_check=True)
    out["train"]["run_s"] = time.perf_counter() - t0
    if not out["train"]["psnr_last"] > out["train"]["psnr_first"]:
        raise AssertionError(f"train_prop: PSNR {out['train']['psnr_first']}"
                             f" -> {out['train']['psnr_last']}")

    # 4. an eval frame, and again from a reloaded checkpoint
    tv = TexturedCloudScene(wh=200, seed=seed)
    t = 0.43
    view = tv.eval_view(theta=0.33 * np.pi, t=t)
    rgb, _, _, ms, launches = _prop_frame(trainer, cfg, pcfg, view, t)
    frame = {"wh": 200, "ms": ms, "psnr": psnr(rgb, view[0]).item(),
             "launches": launches}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prop_")
    try:
        ckpt = os.path.join(tmp, "prop_ckpt")
        save_prop_checkpoint(ckpt, trainer.state, trainer.occ, trainer.step,
                             trainer.generator.get_state())
        step, occ0 = trainer.step, trainer.occ
        del trainer
        torch.cuda.empty_cache()
        fresh = trainer_for(cfg, pcfg, scene, seed + 1)
        fresh.state, fresh.occ, fresh.step, _ = load_prop_checkpoint(
            ckpt, fresh.state, fresh.occ)
        if fresh.step != step or not torch.equal(fresh.occ.binaries,
                                                 occ0.binaries):
            raise AssertionError("prop checkpoint: step or grid lost")
        rgb2, _, _, ms2, _ = _prop_frame(fresh, cfg, pcfg, view, t)
        frame["reload"] = {"ms": ms2, "psnr": psnr(rgb2, view[0]).item(),
                           "bit_equal": bool(np.array_equal(rgb, rgb2))}
        frame["reload"]["psnr_diff_db"] = (frame["reload"]["psnr"]
                                           - frame["psnr"])
        if abs(frame["reload"]["psnr_diff_db"]) > 1e-4:
            raise AssertionError(f"prop reload frame: {frame}")
        out["frame"] = frame
        log(json.dumps({"prop_frame": frame}))
        del fresh, occ0
        torch.cuda.empty_cache()

        # 5. the HyperNeRF family
        hcfg = hypernerf_config("vrig_3dprinter", PROP_HYPER_STEPS)
        hpcfg = tp.PropConfig.for_family("hypernerf")
        hscene = MonocularOrbitScene(n_frames=32, wh=128, seed=seed)
        htr = trainer_for(hcfg, hpcfg, hscene, seed)
        t0 = time.perf_counter()
        out["hypernerf"] = _prop_run("train_prop_hypernerf", htr,
                                     PROP_HYPER_STEPS)
        out["hypernerf"]["run_s"] = time.perf_counter() - t0
        del htr
        torch.cuda.empty_cache()

        # 6. the entry point from disk
        t0 = time.perf_counter()
        small = _write_dnerf_scene(os.path.join(tmp, "small"), 100, 8, 2)
        run = os.path.join(tmp, "run")
        os.makedirs(run)
        base = ["--scene", "lego", "--data_root", os.path.dirname(small),
                "--model_path", os.path.join(tmp, "cli_ckpt")] \
            + PROP_PUBLISHED
        s, secs = _train_real_cli(base + ["--max_steps",
                                          str(PROP_REAL_STEPS)], run,
                                  module="train_prop_real")
        _check_real_run("train_prop_real", s, lattice_eval=False,
                        need_train=False)
        if (any(s["plain_cuda_calls"].values())
                or not s["launches"]["fused_encode_bwd"]
                or not s["launches"]["fused_encode_fwd"]):
            raise AssertionError(f"train_prop_real: launches {s['launches']}"
                                 f" plain {s['plain_cuda_calls']}")
        t1 = time.perf_counter()
        s2 = _in_dir(run, train_prop_real.main,
                     base + ["--load_model", "--render_video"])
        secs2 = time.perf_counter() - t1
        written = (os.path.exists(os.path.join(run, "rgb_render.mp4"))
                   if s2["video"]["mp4"] else
                   len([f for f in os.listdir(run)
                        if f.startswith("rgb_render_")]))
        if (s2["step"] != s["step"] or "eval" in s2
                or s2["video"]["frames"] != 120 or written not in (True, 120)):
            raise AssertionError(f"train_prop_real --load_model "
                                 f"--render_video: {s2}, written {written}")
        out["cli"] = {"step": s["step"], "train_s": s["train_s"],
                      "ms_per_step": s["ms_per_step"],
                      "process_s": secs, "launches": s["launches"],
                      "eval_psnr": s["eval"]["psnr_avg"],
                      "eval_launches": s["eval"]["launches"],
                      "video_frames": s2["video"]["frames"],
                      "video_s": secs2,
                      "s": time.perf_counter() - t0}
        log(json.dumps({"train_prop_real": out["cli"]}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def interp_bwd_kernel_phase(spec, n_main, n_ragged, seed):
    """K7 against its plain version on the full-width field's levels,
    tables uniform(-8, 8), f32 update rows, at the probe's sample count and
    at a ragged one; one bf16 cotangent row in eight zero."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.utils.bench import cuda_ms

    lay = spec.level_layout()
    scales = spec.level_scales()
    nbs = [l["n_bricks_axis"] for l in lay]
    level_rows = [l["rows"] for l in lay]
    L, F = spec.n_levels, spec.n_features
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tables = [((torch.rand((r, 64 * F), device="cuda", generator=gen) * 2
                - 1) * REF_TABLE_BOUND).to(torch.bfloat16) for r in level_rows]
    main = None
    for n in (n_main, n_ragged):
        x = torch.rand((n, 3), device="cuda", generator=gen)
        g = (torch.randn((n, L * F), device="cuda", generator=gen) * 1e-3
             ).to(torch.bfloat16)
        g[::8] = 0
        rows = _level_rows(x, spec)
        feats = torch.stack([tables[l].index_select(0, rows[l].long())
                             for l in range(L)]).contiguous()
        want_u, want_x = ek.interp_bwd_plain(x, g, feats, scales, nbs, F)
        upd, d_x = ek.interp_bwd(x, g, feats, scales, nbs, F)
        torch.cuda.synchronize()
        errs = [_frac_err(upd[l], want_u[l]) for l in range(L)]
        err_x = _frac_err(d_x, want_x)
        if max(errs) > K7_UPD_FRAC or err_x > K7_DX_FRAC:
            raise AssertionError(
                f"interp_bwd N={n}: upd errors per level {errs} (limit "
                f"{K7_UPD_FRAC}), d_x {err_x} (limit {K7_DX_FRAC})")
        rec = {"name": "interp_bwd", "n": n, "levels": L, "n_feat": F,
               "max_abs_err": max((upd - want_u).abs().max().item(),
                                  (d_x - want_x).abs().max().item()),
               "upd_err_frac_per_level": errs, "dx_err_frac": err_x,
               "nonzero_upd_lanes": int((upd != 0).sum().item())}
        del upd, want_u
        if n == n_main:
            rec["ms"] = cuda_ms(
                lambda: ek.interp_bwd(x, g, feats, scales, nbs, F), 20)
            rec["plain_ms"] = cuda_ms(
                lambda: ek.interp_bwd_plain(x, g, feats, scales, nbs, F), 3)
            rec["library_ms"] = None      # no one PyTorch call computes it
            # the f32 rows written once (every lane), x, g and the 8
            # corners of each (sample, level) read once, d_x written once
            out_b = L * n * 64 * F * 4 + n * 3 * 4
            in_b = x.numel() * 4 + g.numel() * 2 + _corner_bytes(n, L, F)
            t_bytes = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
            # per (sample, level): 8F products for the rows, 8F
            # multiply-adds for d_x
            t_ops = n * L * 8 * F * 2 * 2 / F32_FLOPS * 1e3
            rec["bound_ms"] = max(t_bytes, t_ops)
            rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            rec["upd_bytes"] = L * n * 64 * F * 4
            main = rec
        log(json.dumps({"kernel_check": rec}))
        del feats, want_x
        torch.cuda.empty_cache()
    return main


def interp_enc_probe_phase(seed):
    """cednerf_torch.tools.profile_interp_enc at its defaults, counted; then
    its timings from a second run."""
    import torch
    from cednerf_torch.tools import profile_interp_enc as pie

    reset_counts()
    res = pie.run(device="cuda", seed=seed, reps=0)
    torch.cuda.synchronize()
    launches, plain = all_counts()
    log(json.dumps({"probe_interp_enc": res, "launches": launches}))
    if not res["ok"]:
        raise AssertionError(f"profile_interp_enc: outside its limits: {res}")
    want = {"interp_bwd": 1, "scatter_add_rows": res["levels"],
            "interp_fwd": 1, "row_gather": 0}
    if any(launches[k] != v for k, v in want.items()) or any(plain.values()):
        raise AssertionError(f"profile_interp_enc: launches {launches} (want "
                             f"{want}), plain on CUDA {plain}")
    ms = pie.run(device="cuda", seed=seed, reps=20)["ms"]
    log(json.dumps({"probe_interp_enc_ms": ms}))
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms}


def row_gather_kernel_phase(seed, rows=442_368, n=1_048_576):
    """K8 bit-exact against its plain version: the probe's bf16 tables at
    W = 128 and 256, a W = 128 f32 table, and a ragged N with 1% of the
    indices out of range; the in-range cases timed beside their bound and
    index_select (which cannot take an out-of-range index)."""
    import torch
    from cednerf_torch.ops import gather_kernels as gk
    from cednerf_torch.tools.profile_row_gather import bits_equal
    from cednerf_torch.utils.bench import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, rows, (n,), device="cuda", generator=gen,
                        dtype=torch.int32)
    ragged = torch.randint(0, rows, (1_000_003,), device="cuda",
                           generator=gen, dtype=torch.int32)
    ragged[::100] = torch.randint(-rows, 2 * rows, ragged[::100].shape,
                                  device="cuda", generator=gen,
                                  dtype=torch.int32)
    cases = [("W=128 bf16", torch.bfloat16, 128, idx),
             ("W=256 bf16", torch.bfloat16, 256, idx),
             ("W=128 f32", torch.float32, 128, idx),
             ("ragged, out of range", torch.bfloat16, 256, ragged)]
    recs = {}
    for label, dtype, w, ix in cases:
        table = torch.randn((rows, w), device="cuda", generator=gen).to(dtype)
        want = gk.row_gather_plain(table, ix)
        got = gk.row_gather(table, ix)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"row_gather {label}: differs from its "
                                 "plain version")
        valid = ix[(ix >= 0) & (ix < rows)]
        distinct = int(torch.unique(valid).numel())
        rec = {"name": "row_gather", "case": label, "rows": rows, "w": w,
               "n": ix.shape[0], "dtype": str(dtype).split(".")[1],
               "rows_in_flight": gk.DEFAULT_ROWS_IN_FLIGHT, "max_abs_err": 0,
               "out_of_range": int(ix.shape[0] - valid.shape[0]),
               "distinct_rows": distinct}
        del got, want
        if rec["out_of_range"] == 0:
            es = table.element_size()
            rec["ms"] = cuda_ms(lambda: gk.row_gather(table, ix), 20)
            rec["plain_ms"] = cuda_ms(lambda: gk.row_gather_plain(table, ix),
                                      5)
            rec["library_ms"] = cuda_ms(lambda: table.index_select(0, ix), 20)
            # the output written once, the index read once, each distinct
            # row read once; no arithmetic
            rec["bound_ms"] = (ix.shape[0] * w * es + ix.shape[0] * 4
                               + distinct * w * es) / HBM_BYTES_PER_S * 1e3
            rec["bound_by"] = "bytes"
        log(json.dumps({"kernel_check": rec}))
        recs[label] = rec
        del table
    torch.cuda.empty_cache()
    return recs


def row_gather_probe_phase(seed):
    """cednerf_torch.tools.profile_row_gather at its defaults, counted."""
    import torch
    from cednerf_torch.ops import gather_kernels as gk
    from cednerf_torch.tools import profile_row_gather as prg

    reset_counts()
    res = prg.run(device="cuda", seed=seed)
    torch.cuda.synchronize()
    launches, plain = all_counts()
    for rec in res["widths"]:
        log(json.dumps({"probe_row_gather": rec}))
    # each setting: the match run, cuda_ms's warm-up and 20 timed calls
    want = len(res["widths"]) * len(gk.ROWS_IN_FLIGHT) * (1 + 1 + 20)
    if not res["all_match"]:
        raise AssertionError("profile_row_gather: a setting did not match "
                             "index_select")
    others = {k: v for k, v in launches.items() if k != "row_gather" and v}
    if launches["row_gather"] != want or others or any(plain.values()):
        raise AssertionError(f"profile_row_gather: launches {launches} (want "
                             f"row_gather {want} alone), plain on CUDA "
                             f"{plain}")
    return {"launches": launches, "widths": res["widths"]}


# phase 17 (data parallelism): steps a chunk of its Trainers and
# PropTrainers, the blocked K4 lattices, the 2-rank run's limits (phase 6's:
# loss 1e-4, gradients 1% of each norm) and the mesh frame's (phase 4's
# bit-level agreement: one rank renders the whole chunk)
DP_K = 4
DP_BLOCKS = (2, 4, 8)
DP_RAGGED = (3000, 333, 8 * 4096)    # blocks of 124,875 candidates
DP_FRAME_ATOL = 1e-5


def blocked_compact_phase(budget, seed):
    """Blocked K4 (one launch for cfg.compact_blocks > 1) bit-exact against
    its plain version (compact_select, the port of JAX's) for n_blocks 2,
    4, 8 on the top ray bucket's [16000, 1024] lattice at ~10% valid, and
    on a ragged [3000, 333] one (blocks no multiple of 16 candidates, so
    scalar loads at their edges) with block 0 empty and the last block
    full (it overflows its share). The [16000, 1024] cases are timed with
    CUDA events and by profiler device ms, beside the bound (K4's bytes)
    and torch.nonzero on the [n_blocks, R*M / n_blocks] view, one call
    that finds every block's candidates (the library yardstick). Returns
    {n_blocks: record}."""
    import torch
    from cednerf_torch.ops import compact_kernels as ck
    from cednerf_torch.utils.bench import cuda_ms, device_ms

    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    top = torch.rand((16000, 1024), device="cuda", generator=gen) < 0.1
    r, m, rb_budget = DP_RAGGED
    ragged = torch.rand((r, m), device="cuda", generator=gen) < 0.1
    out = {}
    for nbk in DP_BLOCKS:
        rows = r // nbk
        rag = ragged.clone()
        rag[:rows] = False
        rag[-rows:] = True
        for name, valid, bud in (("top", top, budget),
                                 ("ragged", rag, rb_budget)):
            sel, kept = ck.compact_select_kernel(valid, bud, nbk)
            want = ck.compact_select(valid, bud, nbk)
            torch.cuda.synchronize()
            if not (torch.equal(sel, want[0]) and torch.equal(kept, want[1])):
                raise AssertionError(f"compact_select_blocks {name} "
                                     f"{list(valid.shape)} n_blocks {nbk}: "
                                     "differs from its plain version")
            rec = {"name": "compact_select_blocks", "lattice":
                   list(valid.shape), "n_blocks": nbk, "budget": bud,
                   "block_candidates": valid.numel() // nbk,
                   "max_abs_err": 0, "n_valid": int(valid.sum().item()),
                   "n_selected": int(kept.sum().item())}
            if name == "top":
                rec["ms"] = cuda_ms(
                    lambda: ck.compact_select_kernel(valid, bud, nbk), 20)
                rec["plain_ms"] = cuda_ms(
                    lambda: ck.compact_select(valid, bud, nbk), 3)
                view = valid.reshape(nbk, -1)
                rec["library_ms"] = cuda_ms(lambda: torch.nonzero(view), 20)
                rec["device_ms"], rows_k, rec["calls_seen"] = device_ms(
                    lambda: ck.compact_select_kernel(valid, bud, nbk), 20)
                rec["library_device_ms"], _, _ = device_ms(
                    lambda: torch.nonzero(view), 20)
                rec["one_block_ms"] = cuda_ms(
                    lambda: ck.compact_select_kernel(valid, bud), 20)
                rec["device_kernels"] = [row[:2] for row in rows_k]
                if not rows_k:
                    # the profiler recorded no kernel of these launches
                    rec["device_ms"] = None
                n = valid.numel()
                t_bytes = (2 * n + 4 * bud) / HBM_BYTES_PER_S * 1e3
                t_ops = 4 * n / F32_FLOPS * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                out[nbk] = rec
            log(json.dumps({"kernel_check": rec}))
    return out


def _grad_rel(a, b):
    """{parameter: |a - b| / |b|} of two fields' .grad."""
    ga = dict(a.named_parameters())
    return {n: float((ga[n].grad - p.grad).norm() / p.grad.norm().clamp_min(
        1e-30)) for n, p in b.named_parameters()}


def _check_pair(label, got, want, grads):
    """Phase 6's limits between two chunks: loss within 1e-4, every
    parameter's gradient within 1% of its norm."""
    loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    worst = max(grads.values()) if grads else 0.0
    rec = {"loss": got["loss"], "want_loss": want["loss"],
           "loss_rel": loss_err, "grad_rel_max": worst}
    if not (loss_err <= STEP_LOSS_RTOL and worst <= STEP_GRAD_REL):
        raise AssertionError(f"{label}: loss {got['loss']} vs "
                             f"{want['loss']}, gradients {grads}")
    return rec


def dp_rank_main(rank, work_dir, seed):
    """One of two ranks sharing this card over gloo (NCCL refuses two ranks
    on one device; over gloo the mesh runs each collective on a host copy
    of its CUDA tensor): a Trainer(mesh=...) chunk of
    the full-width field with compact_blocks 2 on BallCloudScene's device
    sampler, saved to work_dir/rank{rank}.pt."""
    import torch
    import torch.distributed as dist
    from cednerf_torch.datasets.procedural import BallCloudScene
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.parallel import make_mesh
    from cednerf_torch.utils.bench import TRAIN_FLAGS

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work_dir, "store"), 2),
        rank=rank, world_size=2)
    mesh = make_mesh(device="cuda:0")
    cfg = dataclasses.replace(dnerf_config(), compact_blocks=2)
    flags = ModelFlags(**TRAIN_FLAGS)
    scene = BallCloudScene(seed=seed)
    tr = Trainer(build_field(cfg, flags, device="cuda", seed=seed), cfg,
                 flags, scene, seed=seed, device="cuda",
                 device_sampler=scene.device_sampler(), steps_per_call=DP_K,
                 mesh=mesh)
    reset_counts()
    t0 = time.perf_counter()
    m = tr.run_chunk()
    secs = time.perf_counter() - t0
    launches, plain = all_counts()
    torch.save({"metrics": m, "secs": secs, "launches": launches,
                "plain": plain, "backend": mesh.backend,
                "params": {k: v.cpu() for k, v in
                           tr.field.state_dict().items()},
                "grads": {n: p.grad.cpu()
                          for n, p in tr.field.named_parameters()},
                "occs": tr.state.occ.occs.cpu(),
                "binaries": tr.state.occ.binaries.cpu(),
                "state": {k: v.cpu() if isinstance(v, torch.Tensor) else v
                          for k, v in _snapshot(tr, m).items()}},
               os.path.join(work_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _rank_pair(seed):
    """The two rank processes of dp_rank_main on this card, from `seed`:
    what each saved."""
    import subprocess
    import tempfile

    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, here, "--dp_rank", str(rank), "--dp_dir", work,
         "--seed", str(seed)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"dp rank exited {p.returncode}:\n"
                                 f"{o[-4000:]}")
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


def _two_ranks(seed, ref_field, ref_metrics):
    """Two rank processes on this card (dp_rank_main), then: their
    parameters, occupancy grids and metrics bit-equal, and the pair
    against the one-process compact_blocks=2 chunk at phase 6's limits;
    then the pair once more from the same seed, each rank bit-equal to its
    first run in parameters, occupancy grid, Adam state and chunk_log
    (_snapshot)."""
    import torch

    t0 = time.perf_counter()
    ranks = _rank_pair(seed)
    r0, r1 = ranks
    same = (all(torch.equal(v, r1["params"][k])
                for k, v in r0["params"].items())
            and torch.equal(r0["occs"], r1["occs"])
            and torch.equal(r0["binaries"], r1["binaries"])
            and r0["metrics"] == r1["metrics"])
    if not same:
        raise AssertionError("two ranks on one card: their parameters, "
                             "grids or metrics differ")
    refg = {n: p.grad.cpu() for n, p in ref_field.named_parameters()}
    grads = {n: float((r0["grads"][n] - g).norm() / g.norm().clamp_min(
        1e-30)) for n, g in refg.items()}
    rec = _check_pair("two ranks vs one process compact_blocks=2",
                      r0["metrics"], ref_metrics, grads)
    rec.update(ranks_bit_equal=True, process_s=time.perf_counter() - t0,
               chunk_s=[x["secs"] for x in ranks], backend=r0["backend"],
               launches=[{k: v for k, v in x["launches"].items() if v}
                         for x in ranks])
    if any(v for x in ranks for v in x["plain"].values()):
        raise AssertionError(f"dp ranks: plain versions on CUDA "
                             f"{[x['plain'] for x in ranks]}")
    t1 = time.perf_counter()
    again = _rank_pair(seed)
    diff = {r: _state_diff(ranks[r]["state"], again[r]["state"])
            for r in range(2)}
    rec.update(second_run_s=time.perf_counter() - t1,
               second_run_bit_equal=not any(diff.values()),
               second_run_names=len(ranks[0]["state"]))
    log(f"phase 17: the gloo pair's second run: {rec['second_run_s']:.1f} s")
    if any(diff.values()):
        raise AssertionError(f"two gloo ranks, two runs of one seed: "
                             f"differ in {diff}")
    return rec


def dp_phase(seed):
    """Phase 17, ray data parallelism (parallel/mesh.py) on the one H100:

      1. blocked K4 against its plain version and timed
         (blocked_compact_phase);
      2. the one-process reference: a Trainer chunk (DP_K steps) of the
         full-width field (dnerf_config, -te -ta -f -ae -df -d) with
         compact_blocks 2 on BallCloudScene's device sampler, counters
         zeroed just before and read just after: blocked K4 once a step,
         K5/K6 launched, no single-block K4, no plain version;
      3. two ranks sharing the card over gloo (dp_rank_main, as
         subprocesses): bit-equal parameters, grids and metrics, and
         against step 2 at phase 6's limits (loss 1e-4, gradients 1%);
      4. a one-rank NCCL mesh (make_mesh() alone): Trainer(mesh=...)
         against the mesh-free Trainer, two chunks each (phase 6's
         limits), a chunk's host and device ms a step of each, then a
         chunk dispatched under sync-debug "error" and a run_chunk with
         exactly one host sync;
      5. a render_image(mesh=...) frame of that field against mesh=None
         (DP_FRAME_ATOL on rgb and opacity, depth where opacity >= 1e-2);
      6. PropTrainer(mesh=...) one chunk against the mesh-free one (the
         D-NeRF prop family at PROP_RAYS rays, loss within 1e-4);
      7. `python -m torch.distributed.run --standalone --nproc_per_node 1
         -m cednerf_torch.train_real --dp` on a 100x100 lego-layout scene,
         SMALL_REAL_STEPS steps: "data parallel over 1 device(s)", K5, K6
         and K4 launched, finite outputs."""
    import shutil
    import subprocess
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from cednerf_torch.datasets.procedural import BallCloudScene
    from cednerf_torch.engine import train_prop as tp
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.engine.renderer import (eval_chunk_for,
                                               make_eval_render_fn,
                                               render_image)
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.parallel import make_mesh
    from cednerf_torch.utils.bench import TRAIN_FLAGS, device_ms

    t_phase = time.perf_counter()
    out = {"k4_blocks": blocked_compact_phase(dnerf_config().sample_budget,
                                              seed)}
    cfg = dnerf_config()
    flags = ModelFlags(**TRAIN_FLAGS)
    scene = BallCloudScene(seed=seed)

    def trainer(c, mesh=None):
        return Trainer(build_field(c, flags, device="cuda", seed=seed), c,
                       flags, scene, seed=seed, device="cuda",
                       device_sampler=scene.device_sampler(),
                       steps_per_call=DP_K, mesh=mesh)

    # 2. the one-process compact_blocks=2 program: blocked K4's main path
    ref = trainer(dataclasses.replace(cfg, compact_blocks=2))
    reset_counts()
    ref_m = ref.run_chunk()
    launches, plain = all_counts()
    if (launches["compact_select_blocks"] != DP_K
            or launches["compact_select"]
            or not launches["fused_encode_fwd"]
            or launches["fused_encode_bwd"] != DP_K
            or any(plain.values())):
        raise AssertionError(f"compact_blocks=2 chunk: launches {launches}, "
                             f"plain {plain}")
    no_probe_kernels("dp compact_blocks=2", launches)
    out["blocks2"] = {"metrics": ref_m,
                      "launches": {k: v for k, v in launches.items() if v}}
    log(json.dumps({"dp_blocks2": out["blocks2"]}))

    # 3. two ranks on this card over gloo
    out["two_ranks"] = _two_ranks(seed, ref.field, ref_m)
    log(json.dumps({"dp_two_ranks": out["two_ranks"]}))
    del ref
    torch.cuda.empty_cache()

    # 4. a one-rank NCCL mesh against the mesh-free Trainer
    made = not dist.is_initialized()
    mesh = make_mesh()
    try:
        plain_tr, mesh_tr = trainer(cfg), trainer(cfg, mesh)
        pair = []
        for _ in range(2):
            a, b = plain_tr.run_chunk(), mesh_tr.run_chunk()
            pair.append(_check_pair("one-rank mesh vs mesh-free", b, a,
                                    _grad_rel(mesh_tr.field,
                                              plain_tr.field)))
            # one rank runs the mesh-free program: the same bits
            pair[-1]["params_bit_equal"] = all(
                _same_bits(p, q) for p, q in zip(mesh_tr.field.parameters(),
                                                 plain_tr.field.parameters()))
            if not pair[-1]["params_bit_equal"] or a["loss"] != b["loss"]:
                raise AssertionError(f"one-rank mesh vs mesh-free: not the "
                                     f"same bits: {pair[-1]}")
        # a warmup chunk's host ms and device ms a step, each Trainer
        timing = {}
        for tag, tr in (("mesh_free", plain_tr), ("nccl_mesh", mesh_tr)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run_chunk()
            host = (time.perf_counter() - t0) * 1e3 / DP_K
            dev, _, seen = device_ms(tr.dispatch_chunk, 1)
            timing[tag] = {"host_ms_per_step": host,
                           "device_ms_per_step": dev / DP_K,
                           "device_calls_seen": seen}
        reset_counts()
        syncs = _sync_checked_chunk(mesh_tr)
        launches, plain = all_counts()
        if any(plain.values()) or launches["compact_select"] != 2 * DP_K:
            raise AssertionError(f"one-rank mesh chunks: launches "
                                 f"{launches}, plain {plain}")
        out["one_rank"] = {"backend": mesh.backend, "chunks": pair,
                           "timing": timing,
                           "host_syncs_per_chunk": syncs,
                           "dispatch_syncs": 0,
                           "launches": {k: v for k, v in launches.items()
                                        if v}}
        log(json.dumps({"dp_one_rank": out["one_rank"]}))

        # 5. a frame rendered across the mesh's ranks
        fn = make_eval_render_fn(mesh_tr.field, cfg)
        img = scene.image_rays(0, 0.5)
        args = (mesh_tr.field, mesh_tr.state.occ, fn, img["origins"],
                img["viewdirs"], 0.5, np.ones(3, np.float32))
        reset_counts()
        t0 = time.perf_counter()
        got = render_image(*args, chunk=eval_chunk_for(cfg), mesh=mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        frame_launches, _ = all_counts()
        want = render_image(*args, chunk=eval_chunk_for(cfg))
        seen = want[1] >= 1e-2
        errs = [float(np.abs(got[i] - want[i]).max()) for i in (0, 1)]
        dep = float(np.abs(got[2][seen] - want[2][seen]).max()
                    / max(float(np.abs(want[2][seen]).max()), 1e-30)
                    if seen.any() else 0.0)
        if not (max(errs) <= DP_FRAME_ATOL and dep <= DP_FRAME_ATOL
                and np.isfinite(got[0]).all()):
            raise AssertionError(f"render_image(mesh=): rgb/opacity "
                                 f"{errs}, depth {dep}")
        out["frame"] = {"wh": scene.wh, "ms": ms,
                        "rgb_opacity_err": errs, "depth_rel_err": dep,
                        "launches": {k: v for k, v in frame_launches.items()
                                     if v}}
        log(json.dumps({"dp_frame": out["frame"]}))
        del plain_tr, mesh_tr
        torch.cuda.empty_cache()

        # 6. PropTrainer(mesh=...) against the mesh-free one
        pcfg = tp.PropConfig.for_family("dnerf")
        pflags = ModelFlags(**PROP_FLAGS)

        def prop(m=None):
            field = build_field(cfg, pflags, device="cuda", seed=seed)
            props = tp.build_prop_networks(cfg, pcfg, device="cuda",
                                           seed=seed)
            for mod in (field,) + props:
                mod.density_clamp = pcfg.density_clamp
            return tp.PropTrainer(field, props, cfg, pflags, pcfg,
                                  scene.device_sampler(), n_rays=PROP_RAYS,
                                  seed=seed, steps_per_call=DP_K, mesh=m)

        pa, pb = prop(), prop(mesh)
        reset_counts()
        ma, mb = pa.run_chunk(), pb.run_chunk()
        launches, plain = all_counts()
        rec = _check_pair("PropTrainer one-rank mesh vs mesh-free", mb, ma,
                          {})
        rec["params_bit_equal"] = all(
            _same_bits(p, q) for m1, m2 in zip(pa.state.modules(),
                                                pb.state.modules())
            for p, q in zip(m1.parameters(), m2.parameters()))
        if not rec["params_bit_equal"] or ma["loss"] != mb["loss"]:
            raise AssertionError(f"prop one-rank mesh vs mesh-free: not the "
                                 f"same bits: {rec}")
        if any(plain.values()) or not launches["fused_encode_bwd"]:
            raise AssertionError(f"prop mesh chunk: {launches} {plain}")
        rec["launches"] = {k: v for k, v in launches.items() if v}
        out["prop"] = rec
        log(json.dumps({"dp_prop": rec}))
        del pa, pb
        torch.cuda.empty_cache()
    finally:
        if made:
            dist.destroy_process_group()

    # 7. train_real --dp under torch.distributed.run
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_cli_")
    try:
        small = _write_dnerf_scene(os.path.join(tmp, "dnerf"), 100, 8, 2)
        run = os.path.join(tmp, "run")
        os.makedirs(run)
        env = dict(os.environ)
        repo = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("CEDNERF_CFG", None)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "cednerf_torch.train_real",
             "--dp", "--scene", "lego", "--data_root",
             os.path.dirname(small), "--model_path",
             os.path.join(tmp, "ckpt"), "--max_steps",
             str(SMALL_REAL_STEPS)] + PUBLISHED, cwd=run, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0 or "data parallel over 1 device(s)" \
                not in proc.stdout:
            raise AssertionError(f"train_real --dp exited {proc.returncode}"
                                 f":\n{proc.stdout[-6000:]}")
        last = [ln for ln in proc.stdout.strip().splitlines()
                if ln.startswith('{"train_real"')][-1]
        s = json.loads(last)["train_real"]
        _check_real_run("train_real --dp", s, lattice_eval=False)
        if s.get("dp") != 1:
            raise AssertionError(f"train_real --dp: dp {s.get('dp')}")
        out["cli"] = {"process_s": secs, "step": s["step"],
                      "steady_ms_per_step": s.get("steady_ms_per_step"),
                      "eval_psnr": s["eval"]["psnr_avg"],
                      "launches": s["launches"],
                      "eval_launches": s["eval"]["launches"]}
        log(json.dumps({"dp_cli": out["cli"]}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# phase 18 (reproducibility): the table-gradient kernels launched
# REPRO_LAUNCHES times on each input; the Trainer pairs, each run twice from
# one seed: the full-width 3D path for REPRO_STEPS steps (REPRO_RUN_STEPS by
# run_step, then 16-step chunks: the 256-step warmup and 32 after it), the
# 4D, cell-layout and tri-plane paths for REPRO_SHORT steps (4 warmup
# chunks), the proposal path for REPRO_PROP (2 chunks); the lego command
# twice at its default seed
REPRO_LAUNCHES, REPRO_STEPS, REPRO_RUN_STEPS = 3, 288, 32
REPRO_SHORT, REPRO_PROP, REPRO_K = 64, 32, 16
REPRO_LEGO_SEED = 42           # train_real's default --seed


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(__import__(
        "torch").uint8)


def _same_bits(a, b):
    import torch
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(_bits(a), _bits(b)))


def _one_brick_x(n, gen, scale0):
    """n positions inside one level-0 brick (pos = x * scale + 0.5 in
    [3.01, 5.99) on every axis: brick 1), so every sample shares one key
    on level 0."""
    import torch
    u = 3.01 + torch.rand((n, 3), device="cuda", generator=gen) * 2.98
    return ((u - 0.5) / float(scale0)).float()


def _k6_keys(rows, g, level_rows, F):
    """K6's keys as its first kernel writes them: offset_l + r, INT_MAX
    where the (sample, level)'s cotangent is all zero."""
    import torch
    L, n = rows.shape
    offs = torch.tensor([sum(level_rows[:l]) for l in range(L)],
                        device=rows.device)
    zero = (g.view(n, L, F) == 0).all(-1).t()
    return torch.where(zero, torch.iinfo(torch.int32).max,
                       rows.long() + offs[:, None]).to(
                           torch.int32).contiguous()


def _segment_sum_inputs(keys, x, g, scales, nbs, F, n_table):
    """The ordered reduce's function as one library call takes it:
    (terms [E, F] f32, lengths [n_table * 64] int64) for
    torch.segment_reduce(terms, "sum", lengths=...) -> [n_table * 64, F],
    the table gradient [n_table, 64F]. Each (sample, level) of K6's keys
    [L, N] gives its cell's 8 corner terms w * g (w = wx * wy * wz, the
    corner dx*16 + dy*4 + dz of the brick row), keyed key * 64 + corner and
    sorted stably; dropped keys left out."""
    import torch
    from cednerf_torch.ops.encode_kernels import cell_geom
    L, n = keys.shape
    d = torch.arange(8, device=x.device)
    bits = torch.stack([(d >> 2) & 1, (d >> 1) & 1, d & 1], dim=1)
    ck, terms = [], []
    for lvl in range(L):
        _, _, intra, frac = cell_geom(x, scales[lvl], nbs[lvl])
        w3 = torch.where(bits[None] == 1, frac[:, None, :],
                         1.0 - frac[:, None, :])              # [N, 8, 3]
        w = w3[..., 0] * w3[..., 1] * w3[..., 2]
        corner = ((intra[:, None, :] + bits[None]) *
                  torch.tensor([16, 4, 1], device=x.device)).sum(-1)
        k = keys[lvl].long()
        ok = k < n_table
        ck.append((k[ok, None] * 64 + corner[ok]).reshape(-1))
        terms.append((w[ok, :, None] * g[ok, lvl * F:(lvl + 1) * F]
                      .float()[:, None, :]).reshape(-1, F))
    sk_, order = torch.sort(torch.cat(ck), stable=True)
    lengths = torch.bincount(sk_, minlength=n_table * 64)
    return torch.cat(terms)[order].contiguous(), lengths


def _carry_bytes(keys, tile, width, n_keys):
    """The carry's bytes on these sorted keys: the head partial of
    each tile edge that a run crosses and the tail partial of each run's
    first tile read (width f32 each), each such run's output row read and
    written once."""
    import torch
    k = keys.reshape(-1)
    ends = torch.arange(tile, k.numel(), tile, device=k.device)
    before = k[ends - 1]
    crossing = (k[ends] == before) & (before < n_keys)
    cont = torch.zeros_like(crossing)
    cont[1:] = crossing[:-1] & (k[ends[:-1]] == before[1:])
    runs = int((crossing & ~cont).sum())
    return (int(crossing.sum()) + 3 * runs) * width * 4


def _repro_setup(spec, cell_spec, spec4, seed, n):
    """Phase 18's shared inputs (repro_kernel_phase): the 3D, cell-layout
    and hash4d specs' geometry, bf16 tables of +-REF_TABLE_BOUND, K3's
    level of the 4D field, and the three position sets (uniform,
    ray-major, all samples in one level-0 brick) at n samples, drawn from
    one generator; _repro_case draws the rest of an input from it."""
    import numpy as np
    import torch

    lay = spec.level_layout()
    ctx = dict(scales=spec.level_scales(), nbs=[l["n_bricks_axis"]
                                                 for l in lay],
               level_rows=[l["rows"] for l in lay], L=spec.n_levels,
               F=spec.n_features, spec=spec, cell_spec=cell_spec,
               spec4=spec4, n=n)
    F = ctx["F"]
    ctx["n_table"] = n_table = sum(ctx["level_rows"])
    ctx["gen"] = gen = torch.Generator(device="cuda").manual_seed(seed)
    ctx["table"] = ((torch.rand((n_table, 64 * F), device="cuda",
                                generator=gen) * 2 - 1)
                    * REF_TABLE_BOUND).to(torch.bfloat16)
    ctx["offs"] = np.cumsum([0] + ctx["level_rows"])
    ctx["cell_offs"] = cell_offs = _cell_offsets(cell_spec)
    c_lay = cell_spec.level_layout()
    ctx["c_scales"] = cell_spec.level_scales()
    ctx["c_nbs"] = [l["n_bricks_axis"] for l in c_lay]
    ctx["c_rows"] = c_rows = [l["rows"] for l in c_lay]
    ctx["c_table"] = ((torch.rand((sum(c_rows), 64 * F), device="cuda",
                                  generator=gen) * 2 - 1) * REF_TABLE_BOUND
                      ).to(torch.bfloat16)
    ctx["n_cell"] = 27 * sum(r for r, c in zip(c_rows, cell_offs) if c >= 0)
    lay4 = spec4.level_layout()
    ctx["k4"] = spec4.keyframes
    # K3 on the 4D field's first hashed level (65,536 keyframe rows), in
    # the corner entries the 4D brick levels hand it (key = keyframe row *
    # 64 + corner, F lanes each)
    ctx["l4"] = l4 = next(i for i, l in enumerate(lay4) if l["hashed"])
    ctx["n_rows4"] = lay4[l4]["rows"] * ctx["k4"] * 64
    ctx["inputs"] = {
        "uniform": _draw_x(n, gen, None),
        "ray_major": _ray_major_x(n // 64, seed),
        "one_brick": _one_brick_x(n, gen, ctx["scales"][0])}
    return ctx


def _repro_case(ctx, x):
    """One input of phase 18 at positions x: the cotangent g (every 8th
    sample zero), the rows of the three specs, K2's gathered rows and K3's
    corner entries, drawn from ctx's generator."""
    import torch

    n, L, F, gen = ctx["n"], ctx["L"], ctx["F"], ctx["gen"]
    offs, table, k4 = ctx["offs"], ctx["table"], ctx["k4"]
    g = (torch.randn((n, L * F), device="cuda", generator=gen) * 1e-3
         ).to(torch.bfloat16)
    g[::8] = 0
    rows = _level_rows(x, ctx["spec"])
    feats = torch.stack([table[offs[l]:offs[l + 1]].index_select(
        0, rows[l].long()) for l in range(L)]).contiguous()
    crow = _level_rows(x, ctx["cell_spec"])
    r4 = _level_rows(x, ctx["spec4"])[ctx["l4"]].long()
    lo = r4 * k4 + torch.randint(0, k4 - 1, (n,), device="cuda",
                                 generator=gen)
    bits = torch.tensor([[j >> 2, (j >> 1) & 1, j & 1] for j in range(8)],
                        device="cuda")
    intra = torch.randint(0, 3, (n, 1, 3), device="cuda", generator=gen)
    corner = ((intra + bits) * torch.tensor([16, 4, 1],
                                            device="cuda")).sum(-1)
    key4 = lo[:, None] * 64 + corner
    rows4 = torch.cat([key4, key4 + 64]).reshape(-1).to(
        torch.int32).contiguous()
    upd4 = torch.randn((16 * n, F), device="cuda", generator=gen)
    return dict(x=x, g=g, rows=rows, feats=feats, crow=crow, rows4=rows4,
                upd4=upd4)


def _repro_calls(ek, sk, ctx, c):
    """Phase 18's four kernels on case c through the wrappers of the
    modules ek (ops/encode_kernels) and sk (ops/scatter_kernels): {name:
    call}, each call's outputs a tuple."""
    import torch

    x, g, rows, F = c["x"], c["g"], c["rows"], ctx["F"]
    scales, nbs, level_rows = ctx["scales"], ctx["nbs"], ctx["level_rows"]
    return {
        "fused_encode_bwd": lambda: ek.fused_encode_bwd(
            x, g, rows, ctx["table"], scales, nbs, level_rows, F),
        "interp_bwd_fused": lambda: ek.interp_bwd_fused(
            x, g, c["feats"], rows, scales, nbs, level_rows, F),
        "fused_encode_bwd_cell": lambda: ek.fused_encode_bwd_cell(
            x, g, c["crow"], ctx["c_table"], ctx["c_scales"], ctx["c_nbs"],
            ctx["c_rows"], F, ctx["cell_offs"], torch.bfloat16, False),
        "scatter_add_rows": lambda: (sk.scatter_add_rows(
            c["rows4"], c["upd4"], ctx["n_rows4"]),)}


def repro_kernel_phase(spec, cell_spec, spec4, seed, n):
    """K6, K6c, K2 and K3 launched REPRO_LAUNCHES times on the same inputs
    (uniform, ray-major, all samples in one level-0 brick) at the train
    step's N: bit-equal, within the limits of phases 3, 8 and 15 against
    their plain versions, timed with CUDA events beside their bounds (the
    function's own bytes, and `algo_bound_ms` with the sort's added); the
    reduce with its folded carry and the sort, alone and together; the
    folded carry's rows against carry_plain; the strict-order chain (one
    tile) on level 0 of the one-brick input."""
    import torch
    from cednerf_torch.ops import encode_kernels as ek
    from cednerf_torch.ops import scatter_kernels as sk
    from cednerf_torch.utils.bench import cuda_ms, device_ms

    ctx = _repro_setup(spec, cell_spec, spec4, seed, n)
    scales, nbs, level_rows = ctx["scales"], ctx["nbs"], ctx["level_rows"]
    L, F, n_table, table = ctx["L"], ctx["F"], ctx["n_table"], ctx["table"]
    offs, cell_offs, n_cell = ctx["offs"], ctx["cell_offs"], ctx["n_cell"]
    c_scales, c_nbs, c_rows = ctx["c_scales"], ctx["c_nbs"], ctx["c_rows"]
    c_table, n_rows4 = ctx["c_table"], ctx["n_rows4"]
    out = {}
    for label, x in ctx["inputs"].items():
        case = _repro_case(ctx, x)
        g, rows, feats, crow = case["g"], case["rows"], case["feats"], \
            case["crow"]
        rows4, upd4 = case["rows4"], case["upd4"]
        calls = _repro_calls(ek, sk, ctx, case)
        want_k6 = ek.fused_encode_bwd_plain(x, g, rows, table, scales, nbs,
                                            level_rows, F)
        for name, call in calls.items():
            runs = [call() for _ in range(REPRO_LAUNCHES)]
            # the reduce fed torch.sort's permutation in place of key_sort's
            real_sort = (sk.key_sort, ek.key_sort)
            sk.key_sort = ek.key_sort = torch_key_sort
            try:
                other = call()
            finally:
                sk.key_sort, ek.key_sort = real_sort
            torch.cuda.synchronize()
            equal = all(_same_bits(a, b) for r in runs[1:]
                        for a, b in zip(runs[0], r))
            same_sort = all(_same_bits(a, b) for a, b in zip(runs[0], other))
            del other
            rec = {"name": name, "input": label, "n": n,
                   "launches": REPRO_LAUNCHES, "bit_equal": equal,
                   "bit_equal_with_torch_sort": same_sort}
            if not same_sort:
                raise AssertionError(f"{name} {label}: other bits with "
                                     "torch.sort's permutation")
            if name in ("fused_encode_bwd", "interp_bwd_fused"):
                errs, err_x = _bwd_errors(f"{name} {label}", runs[0],
                                          want_k6, level_rows)
                rec.update(table_err_frac=max(errs), dx_err_frac=err_x)
            elif name == "fused_encode_bwd_cell":
                # K6c into zeroed buffers against the plain version (phase
                # 15's limits: 1e-4 of the largest cell, brick-row and d_x
                # entry)
                args = (x, g, crow, c_table, c_scales, c_nbs, c_rows, F,
                        cell_offs)
                want = ek.fused_encode_bwd_cell_plain(*args)
                got = (torch.zeros_like(want[0]), torch.zeros_like(want[1]),
                       torch.empty_like(want[2]))
                ek._launch_k6c(*args, *got)
                torch.cuda.synchronize()
                brick = torch.repeat_interleave(
                    torch.tensor([o < 0 for o in cell_offs]),
                    torch.tensor(c_rows)).cuda()
                errs = [_frac_err(got[0][brick], want[0][brick]),
                        _frac_err(got[1], want[1]), _frac_err(got[2], want[2])]
                if max(errs) > BWD_TABLE_FRAC:
                    raise AssertionError(f"K6c {label}: errors {errs}")
                rec["err_frac"] = max(errs)
                del want, got
            else:
                want = sk.scatter_add_rows_plain(rows4, upd4, n_rows4)
                err = _frac_err(runs[0][0], want)
                if err > K3_FRAC:
                    raise AssertionError(f"K3 {label}: error {err}")
                rec["err_frac"] = err
                del want
            if not equal:
                raise AssertionError(f"{name} {label}: {REPRO_LAUNCHES} "
                                     f"launches differ")
            rec["ms"] = cuda_ms(call, 20)
            if label == "uniform":
                rec["plain_ms"] = cuda_ms({
                    "fused_encode_bwd": lambda: ek.fused_encode_bwd_plain(
                        x, g, rows, table, scales, nbs, level_rows, F),
                    "interp_bwd_fused": lambda: ek.interp_bwd_fused_plain(
                        x, g, feats, rows, scales, nbs, level_rows, F),
                    "fused_encode_bwd_cell":
                    lambda: ek.fused_encode_bwd_cell_plain(
                        x, g, crow, c_table, c_scales, c_nbs, c_rows, F,
                        cell_offs),
                    "scatter_add_rows": lambda: sk.scatter_add_rows_plain(
                        rows4, upd4, n_rows4)}[name], 3)
                dev, krows, _ = device_ms(call, 5, need_all=True)
                rec["device_ms"] = dev
                rec["device_by_kernel"] = [list(r) for r in krows[:8]]
            if name == "scatter_add_rows":
                sort_b = _ordered_bytes(rows4.numel(), n_rows4, False)
                in_b = upd4.numel() * 4 + rows4.numel() * 4
                out_b = n_rows4 * F * 4
                ops = upd4.numel()
            else:
                sort_b = _ordered_bytes(n * L, n_table if name != (
                    "fused_encode_bwd_cell") else sum(c_rows) + n_cell)
                src_b = {"fused_encode_bwd": table.numel() * 2,
                         "fused_encode_bwd_cell": c_table.numel() * 2,
                         "interp_bwd_fused": _corner_bytes(n, L, F)}[name]
                in_b = x.numel() * 4 + g.numel() * 2 + rows.numel() * 4 \
                    + src_b
                out_b = (n_table if name != "fused_encode_bwd_cell"
                         else sum(c_rows)) * 64 * F * 4 + n * 3 * 4
                ops = n * L * 8 * F * 2 * 2
            t_bytes = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_FLOPS * 1e3
            rec.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       algo_bound_ms=max(t_bytes + sort_b / HBM_BYTES_PER_S
                                         * 1e3, t_ops),
                       sort_bytes=sort_b)
            out[f"{name}/{label}"] = rec
            log(json.dumps({"repro_kernel": rec}))
            del runs
        # the sort and the reduce (its carry folded in), together and each
        # alone, on K6's keys of this input
        keys = _k6_keys(rows, g, level_rows, F)
        flat = keys.reshape(-1)
        d_t = torch.full((n_table, 64 * F), float("nan"), device="cuda")
        sk_ = sk.key_sort(flat, n_table, ek._BWD)[0]
        want_t = ek.table_reduce_plain(keys, x, g, scales, nbs, level_rows,
                                       F, torch.zeros_like(d_t))[0]
        # into a NaN-filled table gradient: every row written
        got_t = ek.table_reduce(keys, x, g, scales, nbs, level_rows, F,
                                d_t)[0]
        torch.cuda.synchronize()

        def reduce_call():
            return ek.table_reduce(keys, x, g, scales, nbs, level_rows, F,
                                   d_t)

        red = {"name": "table_reduce", "input": label, "n": n,
               "max_abs_err": (got_t - want_t).abs().max().item(),
               "err_frac": max(_frac_err(got_t[offs[l]:offs[l + 1]],
                                         want_t[offs[l]:offs[l + 1]])
                               for l in range(L)),
               "sort_ms": cuda_ms(lambda: sk.key_sort(flat, n_table), 20),
               "torch_sort_ms": cuda_ms(lambda: torch.sort(flat, stable=True),
                                        20),
               "ms_with_sort": cuda_ms(reduce_call, 20)}
        if not red["err_frac"] <= BWD_TABLE_FRAC:
            raise AssertionError(f"table_reduce {label}: {red}")
        dev, krows, _ = device_ms(reduce_call, 5, need_all=True)
        red["device_by_kernel"] = [list(r) for r in krows[:8]]
        red["kernels_a_call"] = sum(r[1] for r in krows) / 5
        for kname, key in (("table_reduce_kernel", "reduce_device_ms"),
                           ("keysort::", "sort_device_ms")):
            red[key] = sum(r[2] for r in krows if kname in r[0]) / 5
        red["plain_ms"] = cuda_ms(lambda: ek.table_reduce_plain(
            keys, x, g, scales, nbs, level_rows, F, d_t), 3) \
            if label == "uniform" else None
        # the library call for the same sums: segment_reduce over the
        # sorted corner terms (their build and sort not timed)
        terms, lengths = _segment_sum_inputs(keys, x, g, scales, nbs, F,
                                             n_table)
        lib_t = torch.segment_reduce(terms, "sum", lengths=lengths,
                                     unsafe=True).view(n_table, 64 * F)
        red["library_err_frac"] = _frac_err(lib_t, want_t)
        if red["library_err_frac"] > BWD_TABLE_FRAC:
            raise AssertionError(f"segment_reduce {label}: error "
                                 f"{red['library_err_frac']}")
        red["library_ms"] = cuda_ms(lambda: torch.segment_reduce(
            terms, "sum", lengths=lengths, unsafe=True), 20)
        del terms, lengths, lib_t
        valid = int((flat != torch.iinfo(torch.int32).max).sum())
        # the sorted int32 keys and int32 indices read (8 B an entry), x
        # and g read, every row of d_table written once
        red_b = (flat.numel() * 8 + n * 12 + g.numel() * 2
                 + n_table * 64 * F * 4)
        red["bound_ms"] = max(red_b / HBM_BYTES_PER_S,
                              valid * 8 * F * 2 / F32_FLOPS) * 1e3
        red["bound_by"] = ("bytes" if red_b / HBM_BYTES_PER_S
                           >= valid * 8 * F * 2 / F32_FLOPS else "operations")
        # the carry folded into the reduces: the rows of crossing runs
        # against carry_plain of the partial rows the same launch left, on
        # CPU copies (bit for bit), and carry_plain's time on the card; the
        # fold has no launch of its own to time
        tile, tile3 = sk.REDUCE_TILE, sk.reduce_tile(F)
        part = torch.empty((2, -(-flat.numel() // tile), 64 * F),
                           device="cuda")
        got_c = ek._table_reduce(keys, x, g, scales, nbs, level_rows, F,
                                 d_t, part=part)[0]
        p3 = torch.empty((2, -(-rows4.numel() // tile3), F), device="cuda")
        got_3 = sk._scatter_add_rows(rows4, upd4, n_rows4, part=p3)
        k3 = sk.key_sort(rows4, n_rows4)[0]
        for cname, got, keys_c, part_c, tile_c, n_c, width in (
                ("table_carry", got_c, sk_, part, tile, n_table, 64 * F),
                ("scatter_carry", got_3, k3, p3, tile3, n_rows4, F)):
            chained, want_c = sk.carry_plain(keys_c.cpu(), part_c.cpu(),
                                             tile_c, n_c)
            got_rows = got.cpu()[chained]
            cb = _carry_bytes(keys_c, tile_c, width, n_c)
            crec = {"name": cname, "input": label,
                    "folded_into": ("table_reduce" if cname == "table_carry"
                                    else "scatter_add_rows"),
                    "crossing_rows": len(chained),
                    "bit_equal_to_plain_on_cpu": torch.equal(got_rows,
                                                             want_c),
                    "max_abs_err": (got_rows - want_c).abs().max().item()
                    if len(chained) else 0.0,
                    "ms": None,
                    "plain_ms": cuda_ms(lambda: sk.carry_plain(
                        keys_c, part_c, tile_c, n_c), 3),
                    "bound_ms": cb / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "carry_bytes": cb}
            if not crec["bit_equal_to_plain_on_cpu"]:
                raise AssertionError(f"{cname} {label}: not its plain "
                                     f"version's bits: {crec}")
            out[f"{cname}/{label}"] = crec
            log(json.dumps({"repro_kernel": crec}))
        if any(bool(c.any()) for c in sk._CARRY_COUNTS.values()):
            raise AssertionError(f"{label}: arrival counters left nonzero")
        del part, p3, k3, got_c, got_3
        if label == "one_brick":
            # strict sorted order: level 0's one key in one warp's chain
            k0 = keys[:1].contiguous()
            g0 = g[:, :F].contiguous()
            d0 = torch.empty((level_rows[0], 64 * F), device="cuda")
            for tile, key in ((k0.numel(), "strict_chain_ms"),
                              (sk.REDUCE_TILE, "two_level_ms")):
                red[key] = cuda_ms(lambda: ek._table_reduce(
                    k0, x, g0, scales[:1], nbs[:1], level_rows[:1], F, d0,
                    tile=tile), 5)
        out[f"table_reduce/{label}"] = red
        log(json.dumps({"repro_kernel": red}))
        del feats, want_k6, upd4, want_t, got_t, d_t
        torch.cuda.empty_cache()
    return out


def _flat_state(obj, prefix, out):
    """Every tensor and value of a train state by name: modules' state
    dicts, optimizers' and schedulers' (state_dict), dataclasses, named
    tuples (the occupancy grid), dicts and lists; tensors cloned."""
    import torch
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj.detach().clone()
    elif hasattr(obj, "state_dict") and not isinstance(obj, type):
        _flat_state(obj.state_dict(), prefix, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _flat_state(getattr(obj, f.name), f"{prefix}.{f.name}", out)
    elif hasattr(obj, "_fields"):
        for k in obj._fields:
            _flat_state(getattr(obj, k), f"{prefix}.{k}", out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flat_state(v, f"{prefix}.{k}", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flat_state(v, f"{prefix}.{i}", out)
    elif isinstance(obj, (bool, int, float, str)) or obj is None:
        out[prefix] = obj
    else:
        out[prefix] = repr(obj)
    return out


def _snapshot(trainer, metrics):
    snap = _flat_state(trainer.state, "state", {})
    for k in ("step", "bucket", "steady_march", "chunk_log"):
        if hasattr(trainer, k):
            snap[k] = json.dumps(getattr(trainer, k), default=str)
    snap["metrics"] = json.dumps(metrics, default=str)
    return snap


def _state_diff(a, b):
    """The names whose values differ between two snapshots (tensors bit for
    bit, the host values as their JSON, which prints floats exactly)."""
    import torch
    bad = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and _same_bits(x, y)):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad


def _repro_pair(label, make, drive):
    """make() a trainer from the seed and drive(trainer) -> its metrics,
    twice: every parameter, occupancy grid, optimizer state, the host's
    step, bucket, lattice and chunk_log, and the metrics must be equal bit
    for bit."""
    import torch
    snaps, secs, counts = [], [], None
    for _ in range(2):
        reset_counts()
        tr = make()
        t0 = time.perf_counter()
        metrics = drive(tr)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        snaps.append(_snapshot(tr, metrics))
        counts, plain = all_counts()
        if any(plain.values()):
            raise AssertionError(f"repro {label}: plain versions ran on "
                                 f"CUDA: {plain}")
        del tr
        torch.cuda.empty_cache()
    bad = _state_diff(*snaps)
    rec = {"path": label, "entries": len(snaps[0]),
           "tensors": sum(isinstance(v, torch.Tensor)
                          for v in snaps[0].values()),
           "tensor_bytes": sum(v.numel() * v.element_size()
                               for v in snaps[0].values()
                               if isinstance(v, torch.Tensor)),
           "steps": json.loads(snaps[0]["step"]), "run_s": secs,
           "n_differ": len(bad), "differ": bad[:12],
           "launches": {k: v for k, v in counts.items() if v}}
    log(json.dumps({"repro_run": rec}))
    if bad:
        raise AssertionError(f"repro {label}: two runs of one seed differ "
                             f"in {len(bad)} entries, first {bad[:12]}")
    return rec


def repro_train_phase(seed):
    """Two runs from one seed of each train path at full width (dnerf_config,
    -te -ta -f -ae -df -d): the 3D path by run_step and run_chunk, hash4d,
    row_layout cell with fine_table_rows 65536, the tri-plane encoder and
    a PropTrainer, each bit-equal (_repro_pair)."""
    from cednerf_torch.datasets.procedural import (BallCloudScene,
                                                   TexturedCloudScene)
    from cednerf_torch.engine import train_prop as tp
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.utils.bench import HASH4D_FLAGS, TRAIN_FLAGS

    cfg = dnerf_config()

    def trainer(c, flags, scene_cls):
        def make():
            scene = scene_cls(seed=seed)
            return Trainer(build_field(c, flags, device="cuda", seed=seed), c,
                           flags, scene, seed=seed, device="cuda",
                           device_sampler=scene.device_sampler(),
                           steps_per_call=REPRO_K)
        return make

    def chunks(steps):
        return lambda tr: [tr.run_chunk() for _ in range(steps // REPRO_K)]

    def steps_then_chunks(tr):
        return ([tr.run_step() for _ in range(REPRO_RUN_STEPS)]
                + chunks(REPRO_STEPS - REPRO_RUN_STEPS)(tr))

    out = {"3d": _repro_pair("3d", trainer(cfg, ModelFlags(**TRAIN_FLAGS),
                                           BallCloudScene),
                             steps_then_chunks)}
    out["hash4d"] = _repro_pair(
        "hash4d", trainer(cfg, ModelFlags(**HASH4D_FLAGS), BallCloudScene),
        chunks(REPRO_SHORT))
    out["cell"] = _repro_pair(
        "cell", trainer(dataclasses.replace(cfg, row_layout="cell",
                                            fine_table_rows=65536),
                        ModelFlags(**TRAIN_FLAGS), TexturedCloudScene),
        chunks(REPRO_SHORT))
    out["triplane"] = _repro_pair(
        "triplane", trainer(cfg, ModelFlags(**TRAIN_FLAGS,
                                            grid_type="triplane"),
                            TexturedCloudScene), chunks(REPRO_SHORT))

    def make_prop():
        flags = ModelFlags(**PROP_FLAGS)
        pcfg = tp.PropConfig.for_family("dnerf")
        c = dnerf_config(REPRO_PROP)
        field = build_field(c, flags, device="cuda", seed=seed)
        props = tp.build_prop_networks(c, pcfg, device="cuda", seed=seed)
        for mod in (field,) + props:
            mod.density_clamp = pcfg.density_clamp
        scene = TexturedCloudScene(seed=seed)
        return tp.PropTrainer(field, props, c, flags, pcfg,
                              scene.device_sampler(), n_rays=PROP_RAYS,
                              seed=seed, steps_per_call=REPRO_K,
                              dataset=scene)

    out["prop"] = _repro_pair("prop", make_prop, chunks(REPRO_PROP))
    return out


def audit_main(seed):
    """One step of each train path under torch.use_deterministic_algorithms
    (True, warn_only=True), the process started with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 (repro_phase starts it): prints one
    JSON line, {"audit": {...}}, with every op that PyTorch flags (its
    message's first words, where it was called, how often) and every float
    torch.cumsum on CUDA by shape and dim, and how many of those scanned a
    tensor whose length along dim is its numel (cub's single-pass scan;
    none may)."""
    import collections
    import warnings

    import torch
    from cednerf_torch.ops.cuda_build import build_all

    build_all()
    scans = collections.Counter()
    real_cumsum = torch.cumsum

    def cumsum(x, dim, *args, **kw):
        if x.is_cuda and x.is_floating_point():
            d = dim % x.dim() if x.dim() else 0
            scans[(tuple(x.shape), d, x.numel() == x.shape[d])] += 1
        return real_cumsum(x, dim, *args, **kw)

    torch.cumsum = cumsum
    flagged = collections.Counter()
    paths = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for label, drive in _audit_paths(seed):
                n0 = len(caught)
                drive()
                torch.cuda.synchronize()
                paths.append({"path": label, "flags": len(caught) - n0})
        finally:
            torch.use_deterministic_algorithms(False)
            torch.cumsum = real_cumsum
    for w in caught:
        msg = str(w.message).split(" does not have a deterministic")[0]
        where = f"{os.path.relpath(w.filename)}:{w.lineno}"
        flagged[(msg[:120], where)] += 1
    one_row = sum(c for (s, d, one), c in scans.items() if one)
    res = {"cublas_workspace_config":
           os.environ.get("CUBLAS_WORKSPACE_CONFIG"), "paths": paths,
           "flagged": [{"op": m, "where": w, "count": c}
                       for (m, w), c in sorted(flagged.items())],
           "float_scans": [{"shape": list(s), "dim": d, "one_row": one,
                            "count": c}
                           for (s, d, one), c in sorted(scans.items())],
           "one_row_float_scans": one_row}
    print(json.dumps({"audit": res}))
    return 0 if one_row == 0 else 3


def _audit_paths(seed):
    """(label, drive) of one step (or one 2-step chunk) of each train path
    at full width, each built when its turn comes."""
    from cednerf_torch.datasets.procedural import (BallCloudScene,
                                                   TexturedCloudScene)
    from cednerf_torch.engine import train_prop as tp
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.engine.train import Trainer
    from cednerf_torch.utils.bench import HASH4D_FLAGS, TRAIN_FLAGS

    cfg = dnerf_config()

    def one(c, flags, scene_cls, chunk):
        def drive():
            scene = scene_cls(seed=seed)
            tr = Trainer(build_field(c, flags, device="cuda", seed=seed), c,
                         flags, scene, seed=seed, device="cuda",
                         device_sampler=scene.device_sampler(),
                         steps_per_call=2)
            tr.run_chunk() if chunk else tr.run_step()
        return drive

    yield "3d run_step", one(cfg, ModelFlags(**TRAIN_FLAGS), BallCloudScene,
                             False)
    yield "3d run_chunk", one(cfg, ModelFlags(**TRAIN_FLAGS), BallCloudScene,
                              True)
    yield "hash4d", one(cfg, ModelFlags(**HASH4D_FLAGS), BallCloudScene,
                        True)
    yield "cell", one(dataclasses.replace(cfg, row_layout="cell",
                                          fine_table_rows=65536),
                      ModelFlags(**TRAIN_FLAGS), TexturedCloudScene, True)
    yield "triplane", one(cfg, ModelFlags(**TRAIN_FLAGS,
                                          grid_type="triplane"),
                          TexturedCloudScene, True)

    def prop():
        flags = ModelFlags(**PROP_FLAGS)
        pcfg = tp.PropConfig.for_family("dnerf")
        c = dnerf_config(REPRO_PROP)
        field = build_field(c, flags, device="cuda", seed=seed)
        props = tp.build_prop_networks(c, pcfg, device="cuda", seed=seed)
        for mod in (field,) + props:
            mod.density_clamp = pcfg.density_clamp
        scene = TexturedCloudScene(seed=seed)
        tp.PropTrainer(field, props, c, flags, pcfg, scene.device_sampler(),
                       n_rays=PROP_RAYS, seed=seed, steps_per_call=2,
                       dataset=scene).run_chunk()

    yield "prop", prop


def _audit_subprocess(seed):
    """audit_main in a process of its own with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 (set for that run only): its JSON."""
    import subprocess

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--audit",
         "--seed", str(seed)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=600)
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{"audit"')]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"audit exited {proc.returncode}:\n"
                             f"{proc.stdout[-6000:]}")
    return json.loads(lines[-1])["audit"]


# why each op that the audit may flag gives the same bits on every run here
AUDIT_REASONS = {
    "cumsum_cuda_kernel": (
        "every float CUDA cumsum is flagged; the audit's float_scans show "
        "each of the port's scans a batch of two rows or more (a 1-D one "
        "goes through utils/math.py::row_cumsum), which PyTorch scans one "
        "row at a time in a fixed order (scan_innermost_dim / "
        "scan_outer_dim): one_row_float_scans is 0"),
}


def repro_phase(seed, lego_ref=None):
    """Phase 18 (see the docstring): the kernels, the Trainer pairs, the
    audit and the lego command twice: once more beside the audit, against
    phase 14's run `lego_ref` (its chunks and eval_psnrs), or with no
    phase 14 run, twice at once."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"kernels": _fresh_process_phase("--repro_kernels", seed)}
    out["train"] = repro_train_phase(seed)
    lego_path = os.path.join("results", "repro_lego.json")
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        lego_run = ex.submit(lego_runs, [REPRO_LEGO_SEED],
                             1 if lego_ref else 2, 1 if lego_ref else 2,
                             out_path=lego_path)
        audit = _audit_subprocess(seed)
        lego = lego_run.result()
    for rec in audit["flagged"]:
        rec["reason"] = next((r for op, r in AUDIT_REASONS.items()
                              if op in rec["op"]), None)
    log(json.dumps({"determinism_audit": audit}))
    if audit["one_row_float_scans"] or any(r["reason"] is None
                                           for r in audit["flagged"]):
        raise AssertionError(f"audit: an op without a reason: {audit}")
    out["audit"] = audit
    if lego_ref is not None:
        with open(lego_path) as f:
            run = json.load(f)["runs"][0]
        lego["bit_equal_to_phase_14"] = (
            json.dumps([run["chunks"], run["psnrs"]])
            == json.dumps([lego_ref["chunks"], lego_ref["eval_psnrs"]]))
        same = lego["bit_equal_to_phase_14"]
    else:
        same = lego["seeds"][str(REPRO_LEGO_SEED)]["bit_equal"]
    log(json.dumps({"repro_lego": lego}))
    if not same:
        raise AssertionError(f"lego twice on one seed differ: {lego}")
    out["lego"] = lego
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"reproducibility phase: {out['phase_s']:.1f} s")
    return out


def checked_cli(argv):
    """train_real's main(argv) in this process with every K4 call held bit
    for bit against its plain version and every K6 call against its plain
    version at phase 3's limits (BWD_TABLE_FRAC of each level's largest
    entry, BWD_DX_FRAC of d_x's). A call off its plain version is
    counted, not raised, so the run goes on to its PSNR; the counts are
    printed as the last line, {"checked": {...}}, after the CLI's summary
    line."""
    import numpy as np
    import torch
    from cednerf_torch import train_real
    from cednerf_torch.ops import compact_kernels as ck
    from cednerf_torch.ops import encode_kernels as ek

    real_k4, real_k6 = ck.compact_select_kernel, ek.fused_encode_bwd
    stats = {"k4_calls": 0, "k4_off": 0, "k6_calls": 0, "k6_off": 0,
             "k6_table_worst": 0.0, "k6_dx_worst": 0.0}

    def k4(valid, budget, n_blocks=1):
        sel, kept = real_k4(valid, budget, n_blocks)
        want = (ck.compact_select_rayfold(valid, budget) if n_blocks == 1
                else ck.compact_select(valid, budget, n_blocks))
        stats["k4_calls"] += 1
        stats["k4_off"] += not (torch.equal(sel, want[0])
                                and torch.equal(kept, want[1]))
        return sel, kept

    def k6(x, g, rows, table, scales, nbs, level_rows, n_feat):
        got = real_k6(x, g, rows, table, scales, nbs, level_rows, n_feat)
        want = ek.fused_encode_bwd_plain(x, g, rows, table, scales, nbs,
                                         level_rows, n_feat)
        offs = np.cumsum([0] + list(level_rows))
        table_err = max(_frac_err(got[0][offs[i]:offs[i + 1]],
                                  want[0][offs[i]:offs[i + 1]])
                        for i in range(len(level_rows)))
        dx_err = _frac_err(got[1], want[1])
        stats["k6_calls"] += 1
        stats["k6_off"] += (table_err > BWD_TABLE_FRAC
                            or dx_err > BWD_DX_FRAC)
        stats["k6_table_worst"] = max(stats["k6_table_worst"], table_err)
        stats["k6_dx_worst"] = max(stats["k6_dx_worst"], dx_err)
        return got

    ck.compact_select_kernel, ek.fused_encode_bwd = k4, k6
    try:
        train_real.main(argv)
    finally:
        ck.compact_select_kernel, ek.fused_encode_bwd = real_k4, real_k6
    print(json.dumps({"checked": stats}))


def lego_runs(seeds, repeats, parallel, checked=False,
              out_path="lego_runs.json"):
    """Phase 14's lego command (`python -m cednerf_torch.train_real
    --scene lego --max_steps 1024 -te -ta -f -ae -df -d --seed S` on the
    800x800 lego-layout scene) run `repeats` times for each seed S of
    `seeds`, `parallel` processes at once: each run's eval PSNR, time and
    per-chunk log (Trainer.chunk_log) go to the JSON file `out_path`. A
    run below phase 14's margin over all-white is a collapse; a seed's
    runs must give equal chunk logs and PSNRs (bit_equal). For a seed that
    collapses, the first chunk whose PSNR lies more than 1 dB below every
    other seed's at that chunk (first_out_of_band). checked: each run
    through checked_cli (every K4 and K6 call against its plain version).
    Returns the summary."""
    import shutil
    import tempfile

    import numpy as np
    from cednerf_torch.datasets.dnerf_synthetic import DNeRFSyntheticDataset

    tmp = tempfile.mkdtemp(prefix="chip_smoke_lego_")
    try:
        lego = _write_dnerf_scene(os.path.join(tmp, "dnerf"), LEGO_WH,
                                  LEGO_TRAIN, LEGO_TEST)
        test = DNeRFSyntheticDataset("lego", os.path.dirname(lego), "test")
        white = float(np.mean([-10 * np.log10(np.mean(
            (1.0 - test.image_rays(i)["pixels"]) ** 2))
            for i in range(len(test))]))

        def one(job):
            i, (seed, rep) = job
            run = os.path.join(tmp, f"run{i}")
            os.makedirs(run)
            argv = ["--scene", "lego", "--data_root", os.path.dirname(lego),
                    "--model_path", os.path.join(tmp, f"ckpt{i}"),
                    "--max_steps", str(TRAIN_REAL_STEPS),
                    "--seed", str(seed)] + PUBLISHED
            if checked:
                s, secs, stats = _checked_cli(argv, run)
            else:
                (s, secs), stats = _train_real_cli(argv, run), None
            rec = {"run": i, "seed": seed, "repeat": rep,
                   "psnr": s["eval"]["psnr_avg"], "checked": stats,
                   "psnrs": s["eval"]["psnrs"], "process_s": secs,
                   "train_s": s["train_s"], "chunks": s["chunks"],
                   "plain": {k: v for k, v in s["plain_cuda_calls"].items()
                             if v}}
            log(json.dumps({"lego_run": {k: v for k, v in rec.items()
                                         if k != "chunks"}}))
            return rec

        jobs = list(enumerate((s, r) for s in seeds for r in range(repeats)))
        with concurrent.futures.ThreadPoolExecutor(parallel) as ex:
            runs = list(ex.map(one, jobs))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    limit = white + TRAIN_REAL_MARGIN_DB
    by_seed = {}
    for r in runs:
        by_seed.setdefault(r["seed"], []).append(r)
    per_seed = {}
    for seed, rs in by_seed.items():
        logs = {json.dumps([r["chunks"], r["psnrs"]]) for r in rs}
        per_seed[str(seed)] = {"psnrs": [r["psnr"] for r in rs],
                               "bit_equal": len(logs) == 1,
                               "collapsed": any(r["psnr"] < limit
                                                for r in rs)}
    for seed, rec in per_seed.items():
        if not rec["collapsed"]:
            continue
        others = [np.array([c["psnr"] for c in by_seed[int(s)][0]["chunks"]])
                  for s, o in per_seed.items() if not o["collapsed"]]
        mine = [c for c in by_seed[int(seed)][0]["chunks"]]
        for i, c in enumerate(mine):
            lo = min((o[i] for o in others if len(o) > i), default=None)
            if lo is not None and c["psnr"] < lo - 1.0:
                rec["first_out_of_band"] = {"chunk": i, **c, "band_lo": lo}
                break
    summary = {"runs": len(runs), "repeats": repeats, "parallel": parallel,
               "white_psnr_avg": white, "limit": limit, "seeds": per_seed,
               "psnrs": [r["psnr"] for r in runs],
               "collapses": [s for s, r in per_seed.items() if r["collapsed"]],
               "all_bit_equal": all(r["bit_equal"]
                                    for r in per_seed.values())}
    if checked:
        summary["checked"] = {k: sum(r["checked"][k] for r in runs)
                              for k in ("k4_calls", "k4_off", "k6_calls",
                                        "k6_off")}
        summary["checked"]["k6_table_worst"] = max(
            r["checked"]["k6_table_worst"] for r in runs)
        summary["checked"]["k6_dx_worst"] = max(
            r["checked"]["k6_dx_worst"] for r in runs)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"summary": summary, "runs": runs}, f)
    return summary


def _seed_list(spec):
    """"0-23" or "1,5,9" (or a mix) -> [0, ..., 23] / [1, 5, 9]."""
    seeds = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        seeds.extend(range(int(lo), int(hi or lo) + 1))
    return seeds


def _checked_cli(argv, cwd):
    """checked_cli(argv) as a subprocess in `cwd`: (the CLI's summary,
    seconds, the checked counts). Fails on a non-zero exit."""
    import subprocess

    env = dict(os.environ)
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("CEDNERF_CFG", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(repo, "chip_smoke.py"),
                           "--checked_cli"] + argv, cwd=cwd, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=1200)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"checked train_real {argv} exited "
                             f"{proc.returncode}:\n{proc.stdout[-6000:]}")
    lines = proc.stdout.strip().splitlines()
    return (json.loads(lines[-2])["train_real"], secs,
            json.loads(lines[-1])["checked"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lego_runs", type=int, default=0,
                    help="only run phase 14's lego command this many times "
                         "at its default seed (lego_runs) and print their "
                         "PSNRs")
    ap.add_argument("--lego_seeds", default="",
                    help="only run phase 14's lego command for these seeds "
                         "(\"0-23\", \"1,5,9\"), --lego_repeats times each "
                         "(lego_runs)")
    ap.add_argument("--lego_repeats", type=int, default=2,
                    help="runs of each --lego_seeds seed")
    ap.add_argument("--lego_parallel", type=int, default=1,
                    help="lego runs at once")
    ap.add_argument("--lego_checked", action="store_true",
                    help="each lego run through checked_cli")
    ap.add_argument("--lego_out", default="lego_runs.json",
                    help="where --lego_runs writes its runs (JSON)")
    ap.add_argument("--checked_cli", nargs=argparse.REMAINDER,
                    help="run train_real with these arguments through "
                         "checked_cli (started by --lego_checked)")
    ap.add_argument("--dp_rank", type=int, default=-1,
                    help="run one rank of phase 17's two-rank gloo chunk "
                         "(dp_rank_main; started by phase 17 itself)")
    ap.add_argument("--dp_dir", default="")
    ap.add_argument("--audit", action="store_true",
                    help="run phase 18's determinism audit (audit_main; "
                         "started by phase 18 itself)")
    ap.add_argument("--sort_phase", default="",
                    help="run phase 8b in this directory (sort_phase_main; "
                         "started by the whole run)")
    ap.add_argument("--repro_kernels", default="",
                    help="run phase 18's kernel part in this directory "
                         "(repro_kernels_main; started by phase 18)")
    ap.add_argument("--sort_ab", action="append", default=[],
                    metavar="DIR",
                    help="only hold phase 18's reduces and phase 8b's "
                         "sorts to the checkout at DIR's and time both in "
                         "turns (sort_ab_main; repeatable)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.dp_rank >= 0:
        dp_rank_main(args.dp_rank, args.dp_dir, args.seed)
        return 0
    if args.checked_cli is not None:
        checked_cli(args.checked_cli)
        return 0
    if args.audit:
        return audit_main(args.seed)
    if args.sort_phase:
        sort_phase_main(args.sort_phase, args.seed)
        return 0
    if args.repro_kernels:
        repro_kernels_main(args.repro_kernels, args.seed)
        return 0
    if args.sort_ab:
        sort_ab_main(args.sort_ab, args.seed)
        return 0
    if args.lego_runs or args.lego_seeds:
        from cednerf_torch.ops.cuda_build import build_all
        from cednerf_torch.utils.bench import card_name
        log(card_name())
        build_all()
        if args.lego_seeds:
            seeds, repeats = _seed_list(args.lego_seeds), args.lego_repeats
        else:
            seeds, repeats = [REPRO_LEGO_SEED], args.lego_runs
        summary = lego_runs(seeds, repeats, args.lego_parallel,
                            args.lego_checked, args.lego_out)
        log(card_name())
        print(json.dumps({"lego_runs": summary}))
        if not summary["all_bit_equal"]:
            return 3
        return 0 if not summary["collapses"] else 2
    from cednerf_torch.engine.cli import build_field
    from cednerf_torch.engine.config import ModelFlags, dnerf_config
    from cednerf_torch.ops.cuda_build import build_all
    from cednerf_torch.utils.bench import (TRAIN_FLAGS, card_name,
                                           fill_occupancy)

    t_start = time.perf_counter()
    log(card_name())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    builds = build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        + ", ".join(f"{k} (nvcc {v[0]:.2f} s)" for k, v in builds.items()))
    for stem, (_, build_log) in builds.items():
        for line in build_log.splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line):
                log(f"ptxas {stem}: " + line.strip())

    cfg = dnerf_config()
    flags = ModelFlags(use_time_embedding=True, use_time_attenuation=True,
                       use_feat_predict=True, use_div_offsets=True)
    field = build_field(cfg, flags, device="cuda", seed=args.seed)
    field_k1 = build_field(dataclasses.replace(cfg, interp_impl="interp"),
                           flags, device="cuda", seed=args.seed)
    n_params = sum(p.numel() for p in field.parameters())
    log(f"field: {n_params} params, {n_params * 4 / 2 ** 20:.1f} MiB f32")

    n_main = cfg.eval_chunk_seg * 64   # one full seg-eval pass
    kern = kernel_phase(field, n_main, 1_000_003, args.seed)
    kern.update(backward_kernel_phase(field, cfg.sample_budget, 100_003,
                                      args.seed))
    cells = cell_kernel_phase(field.hash_encoder.bspec, args.seed)
    kern["compact_select"] = compact_kernel_phase(cfg.sample_budget,
                                                  args.seed)

    t0 = time.perf_counter()
    occ = fill_occupancy(field, cfg, args.seed, "cuda")
    torch.cuda.synchronize()
    occ_frac = occ.binaries.float().mean().item()
    log(f"occupancy: {cfg.grid_resolution}^3 all-cells update "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, occupied {occ_frac:.4f}")

    ref = reference_phase(field, occ, cfg, flags, args.seed)
    log(json.dumps({"reference": ref}))

    frames, serve_launches = serving_phase(field, field_k1, occ, cfg)
    spec3d = field.hash_encoder.bspec
    del field, field_k1, occ
    torch.cuda.empty_cache()

    log(json.dumps({"reference_step": reference_step_phase(args.seed)}))

    train = training_phase(cfg, ModelFlags(**TRAIN_FLAGS), args.seed)
    log(json.dumps({"training": train}))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    scanned = scanned_phase(cfg, ModelFlags(**TRAIN_FLAGS), args.seed)
    log(json.dumps({"scanned_training": scanned}))
    log(f"scanned training: {time.perf_counter() - t0:.1f} s")

    k3, sort_keys = scatter_kernel_phase(cfg, args.seed)
    k3_keys = ("m", "w", "n_rows", "tile", "max_abs_err", "err_frac", "ms",
               "plain_ms", "library_ms", "library_det_ms", "bound_ms",
               "algo_bound_ms")
    kern["scatter_add_rows"] = dict(k3["hashed level"], **{
        key: {k: k3[case][k] for k in k3_keys}
        for key, case in (("level_0", "level 0"),
                          ("row_form", "hashed level, row form"),
                          ("ragged", "ragged random rows"),
                          ("triplane", "tri-plane texels"))})
    torch.cuda.empty_cache()
    sorts = _fresh_process_phase("--sort_phase", args.seed, sort_keys)
    del sort_keys
    kern["key_sort"] = dict(sorts["k6 uniform"], by_case={
        case: {k: r[k] for k in ("m", "n_keys", "passes", "ms", "device_ms",
                                 "kernels_a_sort",
                                 "library_ms", "library_device_ms",
                                 "bound_ms", "algo_bound_ms")}
        for case, r in sorts.items()})
    log(json.dumps({"reference_step": reference_step_phase(args.seed,
                                                           "hash4d")}))
    h4 = hash4d_phase(cfg, args.seed)
    log(json.dumps({"hash4d_training": h4}))
    torch.cuda.empty_cache()

    hyper = hypernerf_phase(args.seed)
    log(json.dumps({"hypernerf": {k: v for k, v in hyper.items()
                                  if k not in ("frame_check", "step_check")}}))
    log(f"hypernerf phase: {hyper['phase_s']:.1f} s")

    real = train_real_phase(args.seed, scanned["median_ms_per_step_steady"])
    log(f"train_real phase: {real['phase_s']:.1f} s")

    sec, sec_kern = secondary_phase(args.seed)
    kern["fused_encode_bwd_cell"] = sec_kern["fused_encode_bwd_cell"]
    kern["fold_cells"] = sec_kern["fold_cells"]
    log(json.dumps({"secondary": {k: v for k, v in sec.items()
                                  if k != "reference_steps"}}))
    log(f"secondary phase: {sec['phase_s']:.1f} s")

    prop = proposal_phase(args.seed)
    log(json.dumps({"proposal": {k: v for k, v in prop.items()
                                 if k != "kernel_checks"}}))
    log(f"proposal phase: {prop['phase_s']:.1f} s")

    dp = dp_phase(args.seed)
    kern["compact_select_blocks"] = dp["k4_blocks"][2]
    log(f"data-parallel phase: {dp['phase_s']:.1f} s")

    repro = repro_phase(args.seed, lego_ref=real["train"])
    rk = repro["kernels"]
    for name in ("fused_encode_bwd", "interp_bwd_fused",
                 "fused_encode_bwd_cell", "scatter_add_rows"):
        kern[name]["repro"] = {
            inp: {k: rk[f"{name}/{inp}"][k] for k in (
                "bit_equal", "bit_equal_with_torch_sort", "ms", "device_ms",
                "bound_ms", "algo_bound_ms")
                if k in rk[f"{name}/{inp}"]}
            for inp in ("uniform", "ray_major", "one_brick")}
    red = rk["table_reduce/uniform"]
    kern["table_reduce"] = dict(
        red, ms=red["reduce_device_ms"],
        by_input={inp: {k: rk[f"table_reduce/{inp}"].get(k) for k in (
            "reduce_device_ms", "sort_device_ms", "kernels_a_call",
            "sort_ms", "torch_sort_ms", "ms_with_sort", "bound_ms",
            "library_ms", "strict_chain_ms", "two_level_ms")}
            for inp in ("uniform", "ray_major", "one_brick")})
    for name in ("table_carry", "scatter_carry"):
        # folded into the reduce kernels: no launch and no time of its
        # own; its rows held to carry_plain where it has the most work (all
        # samples in one level-0 brick)
        rec = rk[f"{name}/one_brick"]
        kern[name] = dict(rec, library_ms=None,
                          status=f"folded into {rec['folded_into']}",
                          by_input={inp: {k: rk[f"{name}/{inp}"][k] for k in (
                              "crossing_rows", "max_abs_err", "plain_ms",
                              "bound_ms")}
                              for inp in ("uniform", "ray_major",
                                          "one_brick")})

    t0 = time.perf_counter()
    kern["interp_bwd"] = interp_bwd_kernel_phase(spec3d, 262_144, 100_003,
                                                 args.seed)
    probe_enc = interp_enc_probe_phase(args.seed)
    k8 = row_gather_kernel_phase(args.seed)
    kern["row_gather"] = k8["W=256 bf16"]
    probe_gather = row_gather_probe_phase(args.seed)
    log(f"probe phases 11-12: {time.perf_counter() - t0:.1f} s")

    replaces = {
        "fused_encode_fwd": "cednerf_tpu/ops/pallas_fused.py:138",
        "interp_fwd": "cednerf_tpu/ops/pallas_encoder.py:136",
        "fused_encode_bwd": "cednerf_tpu/ops/pallas_fused.py:244",
        # the cell levels' table-gradient scatter: JAX's _scatter_rows into
        # [rows*27, 8F] (its Pallas route: scatter_add_rows)
        "fused_encode_bwd_cell": "cednerf_tpu/ops/pallas_scatter.py:87",
        # the transpose of the cell layouts' expansion dot (its backward)
        "fold_cells": "cednerf_tpu/ops/brick_grid.py:684",
        "interp_bwd_fused": "cednerf_tpu/ops/pallas_encoder.py:307",
        "compact_select": "cednerf_tpu/ops/pallas_compact.py:47",
        # compact_select(n_blocks) of the ray-parallel layout: XLA ops in
        # the JAX package (no Pallas kernel), K4's blocked launch here
        "compact_select_blocks": "cednerf_tpu/engine/renderer.py:55",
        "scatter_add_rows": "cednerf_tpu/ops/pallas_scatter.py:87",
        # the table-gradient sums that the TPU backward kernels take in
        # one order (one core walks the sample tiles); here a sort and the
        # ordered reduce with its carry folded in (the carries' entries
        # stay, with no launch of their own)
        "table_reduce": "cednerf_tpu/ops/pallas_fused.py:244",
        "table_carry": "cednerf_tpu/ops/pallas_fused.py:244",
        "scatter_carry": "cednerf_tpu/ops/pallas_scatter.py:87",
        # the sort in front of those sums (K6's, K6c's, K2's and K3's):
        # the order the TPU kernels take by walking the tiles on one core
        "key_sort": "cednerf_tpu/ops/pallas_fused.py:244",
        "interp_bwd": "cednerf_tpu/ops/pallas_encoder.py:180",
        "row_gather": "cednerf_tpu/ops/pallas_gather.py:27",
    }
    sources = {
        "fused_encode_fwd": "cednerf_torch/csrc/brick_encode_fwd.cu",
        "interp_fwd": "cednerf_torch/csrc/brick_encode_fwd.cu",
        "fused_encode_bwd": "cednerf_torch/csrc/brick_encode_bwd.cu",
        "fused_encode_bwd_cell": "cednerf_torch/csrc/brick_encode_bwd.cu",
        "fold_cells": "cednerf_torch/csrc/brick_encode_bwd.cu",
        "interp_bwd_fused": "cednerf_torch/csrc/brick_encode_bwd.cu",
        "compact_select": "cednerf_torch/csrc/compact_select.cu",
        "compact_select_blocks": "cednerf_torch/csrc/compact_select.cu",
        "scatter_add_rows": "cednerf_torch/csrc/scatter_add_rows.cu",
        "table_reduce": "cednerf_torch/csrc/brick_encode_bwd.cu",
        "table_carry": "cednerf_torch/csrc/ordered_reduce.cuh",
        "scatter_carry": "cednerf_torch/csrc/ordered_reduce.cuh",
        "key_sort": "cednerf_torch/csrc/key_sort.cuh",
        "interp_bwd": "cednerf_torch/csrc/brick_encode_bwd.cu",
        "row_gather": "cednerf_torch/csrc/row_gather.cu",
    }
    line = []
    for name in replaces:
        r = kern[name]
        by_path = {"serve": serve_launches.get(name, 0),
                   "train": train["launches"].get(name, 0),
                   "train_interp": train["interp"]["launches"].get(name, 0),
                   "train_scanned": scanned["launches"].get(name, 0),
                   "train_scanned_seg":
                   scanned["march_seg"]["launches"].get(name, 0),
                   "train_hash4d": h4["launches"].get(name, 0),
                   "serve_hash4d": h4["frame"]["launches"].get(name, 0),
                   "train_hypernerf": hyper["train"]["launches"].get(name, 0),
                   "serve_hypernerf": hyper["serve_launches"].get(name, 0),
                   "train_real": real["train"]["launches"].get(name, 0),
                   "eval_real": real["train"]["eval_launches"].get(name, 0),
                   "train_real_hypernerf":
                   real["vrig_chicken"]["launches"].get(name, 0),
                   "train_real_dynerf":
                   real["cook_spinach"]["launches"].get(name, 0),
                   "train_cell_texture":
                   sec["train_cell_texture"]["launches"].get(name, 0),
                   "train_hash4motion":
                   sec["train_hash4motion"]["launches"].get(name, 0),
                   "train_triplane":
                   sec["train_triplane"]["launches"].get(name, 0),
                   "train_gather":
                   sec["train_gather"]["launches"].get(name, 0),
                   "train_prop": prop["train"]["launches"].get(name, 0),
                   "eval_prop": prop["frame"]["launches"].get(name, 0),
                   "train_prop_hypernerf":
                   prop["hypernerf"]["launches"].get(name, 0),
                   "train_prop_real": prop["cli"]["launches"].get(name, 0),
                   "eval_prop_real":
                   prop["cli"]["eval_launches"].get(name, 0),
                   "train_blocks2": dp["blocks2"]["launches"].get(name, 0),
                   "train_dp2_ranks": sum(
                       r.get(name, 0) for r in dp["two_ranks"]["launches"]),
                   "train_dp1_nccl":
                   dp["one_rank"]["launches"].get(name, 0),
                   "serve_dp": dp["frame"]["launches"].get(name, 0),
                   "train_prop_dp": dp["prop"]["launches"].get(name, 0),
                   "train_real_dp": dp["cli"]["launches"].get(name, 0),
                   "eval_real_dp": dp["cli"]["eval_launches"].get(name, 0),
                   **{f"train_repro_{p}": r["launches"].get(name, 0)
                      for p, r in repro["train"].items()},
                   "probe_interp_enc": probe_enc["launches"].get(name, 0),
                   "probe_row_gather": probe_gather["launches"].get(name, 0)}
        line.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
        line[-1].update({k: r[k] for k in (
            "status", "sector_bound_ms", "algo_bound_ms", "ray_major_ms",
            "device_ms", "library_device_ms", "library_det_ms", "repro",
            "by_input", "by_case", "level_0", "row_form", "ragged",
            "triplane")
            if k in r})
        if name == "compact_select_blocks":
            line[-1]["by_blocks"] = {
                nbk: {k: rec[k] for k in ("ms", "device_ms", "one_block_ms",
                                          "plain_ms", "library_ms",
                                          "bound_ms")}
                for nbk, rec in dp["k4_blocks"].items()}
        if name == "fused_encode_bwd":
            line[-1]["one_brick_ms"] = cells[-1]["ms"]
        if name == "fused_encode_bwd_cell":
            line[-1].update({k: r[k] for k in (
                "k6_same_inputs_ms", "corner_bound_ms", "old_k6c_ms",
                "pair_ms", "old_pair_ms", "touched_brick_row_share")})
            line[-1]["ray_major_ms"] = r["ray_major"]["ms"]
            line[-1]["n_1m"] = {k: r["n_1m"][k] for k in (
                "n", "ms", "fold_ms", "pair_ms", "old_pair_ms",
                "k6_same_inputs_ms")}
        if name == "fold_cells":
            k6c = kern["fused_encode_bwd_cell"]
            line[-1].update({
                "old_fold_pair_ms": r["old_fold_pair_ms"],
                "ray_major_ms": k6c["ray_major"]["fold_ms"],
                "n_1m_ms": k6c["n_1m"]["fold_ms"],
                "train_cell_texture_device_ms_per_step":
                sec["train_cell_texture"]["fold_device_ms_per_step"]})
        mg = {"fused_encode_fwd": "motion_grid_fwd",
              "fused_encode_bwd": "motion_grid_bwd"}.get(name)
        if mg:       # the hash4motion grid's levels (F = 2)
            line[-1]["motion_grid"] = {
                k: sec_kern[mg][k] for k in ("n", "n_feat", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "max_abs_err")}
        if name in ("fused_encode_fwd", "fused_encode_bwd"):
            # the proposal fields' layouts (L5 F2, 2^17), each input
            for key, rec in prop["kernel_checks"].items():
                r = rec[name]
                line[-1][key] = {k: r[k] for k in (
                    "n", "n_feat", "ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err", "table_err_frac_per_level")
                    if k in r}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card_name())
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
