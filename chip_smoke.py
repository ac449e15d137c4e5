"""Chip smoke of the PyTorch/CUDA port: drives ``ncnet_tpu_torch`` on one
NVIDIA GPU and fails unless every phase holds.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — CUDA must be present; the card's name and power limit.
2. build   — the five kernel libraries (conv4d forward, which dx reuses;
             conv4d dw; band GEMM forward; band dw with the hit list; band
             dx) are built with nvcc from the
             repository's sources, one nvcc each, started together
             (seconds and ptxas's register/spill report); then each
             library's HMMA/HGMMA (tensor-core) instructions per kernel
             function, from ``cuobjdump -sass``: the bfloat16 routes of
             conv4d forward and dw and of the band dw and dx (functions
             named ``bf16_tc``) and the float32 split-TF32 routes of the
             conv4d forward and dw (``tf32x3``) must have some in every
             function, and their CUDA-core (FFMA) functions none, and the
             conv4d forward's two FFMA functions (``conv4d_fwd_ffma_c1``,
             ``conv4d_fwd_ffma_o1``) must be there, or the phase fails;
             without cuobjdump the phase says so.
3. kernels — the conv4d kernel against its plain PyTorch version (TF32
             off) at the PF-Pascal NC layer shapes (batch 2x2 on the 25^4
             grid), a rectangular grid (all three layers) and a tiny grid,
             float32 and bfloat16, every float32 layer with one input or
             one output channel (the FFMA route) also bit for bit against
             the chain oracle (one fmaf chain an output, in (di, dj, dk,
             dl, c) order); then each layer timed with CUDA events at the
             serving path's square-batch shape, beside its plain version
             and its bound (float32-accurate work at the split-TF32 rate,
             495/3 TFLOP/s; the FFMA layers also at FFMA's 67), with its
             route (split-TF32 tensor cores or FFMA, by the kernel's shape
             rule), held to TOL, to a bitwise repeat and (FFMA) to the
             oracle's bits.
4. band_kernels — the band kernel, which derives each entry's neighbours
             from the band's indices, against its plain version (pointer
             table, gather, matmul, TF32 off) on real K = 16 mutual bands
             built by the port from random features on 25x25 grids (the
             three PF-Pascal layer shapes, both passes), a 25x25 against
             19x25 band, K = 50, the complete band at 192 px (12x12, K =
             144; 12x12 against 9x12, K = 108), a tiny grid; float32 and
             bfloat16; then each layer and pass timed at the served square
             batch (4 pairs; CUDA events around the wrapper's calls, the
             kernel's own device time from ``torch.profiler``, and the
             host's time to issue one call), beside the plain version,
             the hits (the non-null tap share) and the bound, held to its
             tolerance and to a bitwise repeat.
4b. band_train_kernels — the band layer's kernels at band training's
             shapes: the K = 50 mutual band of one training batch (16
             synthetic pairs through the trunk, as the train_band step
             builds it; 25x25 grids, 16 x 31,250 entries), both passes,
             the three layers, bfloat16:
             the forward, dx (csrc/band_gemm_dx.cu; layers 2 and 3) and
             dw (csrc/band_gemm_dw.cu), both over the pass's hit list,
             built once a pass and shared, against their plain versions
             (per sample, float32 sums of the same bfloat16 inputs), each
             repeated bitwise (the hit list and its per-(tap, block)
             offsets too), timed by CUDA events beside the plain version
             in bfloat16 and the bound (FLOPs of this band's hits against
             the bytes of the entry lists, indices and weights); the hit
             list's build timed beside its own bound (the bytes it
             writes: 8 a hit and its offsets); then dx and dw of the
             16->16 layer on K = 16 and K = 50 bands of random features
             (as many (cell, tap) pairs, fewer hits: the "walk" record).
5. serve   — ImMatchNet at the PF-Pascal config (ResNet-101, NC 5-5-5 /
             16-16-1, 400 px) with random weights from a seed behind the
             port's ServeEngine: 8 requests at the 400x400 bucket and 4 at
             400x400 against 304x400. Every future must resolve with
             finite matches; the kernel's launch count over the served
             batches must be 3 per square batch and 6 per rectangular one;
             one request must agree with the forward through the plain
             conv4d on the card.
6. serve_band — the same model behind a ServeEngine whose standard program
             is dense and whose degraded program is the K = 16 band
             (``make_serve_match_step(config.replace(nc_topk=16))``), both
             warmed on both buckets: 8 requests pinned ``degraded`` (square
             and rectangular) and 2 unpinned. Every future must resolve
             with finite matches; the band kernel must launch exactly 6
             times per degraded batch and conv4d 3 per standard square
             batch (6 per rectangular); one degraded request per bucket
             must agree with the band forward through the plain band layer
             on the card; no pointer table may be built while serving (a
             call counter on ``band_neighbor_pointers``). Then the band
             forward's stage times, again with no table built.
7. full_k  — at 192 px (12x12 grids, K = 144 = hB*wB, and 12x9 with K =
             108) the band forward through the band kernel equals the
             dense forward through the conv4d kernel.
8. train_kernels — the conv4d backward kernels against their plain
             versions (TF32 off) at every training layer shape (dx: the
             16->16 and 16->1 layers, whose inputs need a gradient; dw:
             all three) at 2 samples on the 25^4 grid, float32 and
             bfloat16; then the forward, dx and dw timed at the training
             batch (16 pairs x 2 symmetric directions = 32 samples per
             pipeline call, the bfloat16 of the training path) beside
             their plain versions and bounds, each timed launch held to
             its tolerance, and the forward and dw called twice on the
             same inputs: the two results must be bitwise equal. Then dw
             on the 48x48 grid of 768 px (past the grids whose whole halo
             fitted a block), all three layers, float32 and bfloat16, at 1
             sample against the plain version with a bitwise repeat, and
             timed in bfloat16 at the 4 samples of a 768 px pipeline call
             and in float32 at 1 sample. Then the float32 dw (split-TF32:
             ``--no-bf16`` training, the gradient check, the synthetic
             float32 run) timed at 2 samples and at the 32 of a
             ``--no-bf16`` pipeline call, all three layers, beside the
             plain version, the bound and the FFMA ceiling, with the
             device time of its split, pass 1 and pass 2 (from a trace
             that holds every launch the wrapper made, else none), each
             held to DW_TOL with a bitwise repeat; and the float32 dw at
             the shapes the old route refused (C4: 5^4 16->64 and 64->16,
             7^4 32->16) and at the 1->16 layer on an odd count of
             positions against the plain version with a bitwise repeat.
8b. synthetic_kernels — the forward, dx and dw at the synthetic
             convergence run's shapes ([16, 8, 8, 8, 8], 3^4, 1->16 and
             16->1), float32 and bfloat16, against their plain versions
             with a bitwise repeat, the float32 forward and dx (the FFMA
             route) bit for bit against the chain oracle; timed beside the
             plain versions and the bounds.
9. train   — (a) the NC gradients at the PF-Pascal width (ResNet-101,
             400 px, 5-5-5 / 16-16-1), 2 pairs, of a random linear
             functional of the NC output and of the weak loss's positive
             term, float32 through the kernels, against the same model
             with the plain differentiable conv4d (cuDNN's conv3d and its
             autograd) on float64 correlations: within 4x the same plain
             version's own float32 error (see GRAD_RATIO); the 16->1
             layer's dx of each (FFMA) bit for bit the chain oracle's;
             (b) 3 Adam steps of the trainer API (create_train_state /
             make_train_step) at batch 16, bfloat16, on SyntheticPairDataset:
             finite float32 losses, float32 masters and Adam state, every
             NC kernel moved, trunk bitwise unchanged, and exactly 6 conv4d
             forward, 4 dx and 6 dw launches per step; then one step's
             stage times and the peak memory; (c) one step at 768 px
             (48x48 grids), batch 2: a finite loss and 6 / 4 / 6 launches;
             (b') the stage breakdown of 2 float32 steps at batch 16
             (``half_precision=False``, as ``--no-bf16``), the second under
             torch.profiler (again, up to 3 steps, where the trace lacks a
             launch the dw wrapper made): the dw launches' device time by
             pass and share of the backward, and the step's peak memory;
             (d) ``python -m
             ncnet_tpu_torch.train --synthetic --allow_random_fe
             --max-steps 2`` in a subprocess: its report comes back and its
             checkpoint loads.
9b. train_band — band training (``nc_topk = 50``, mutual) at the
             PF-Pascal config: (a) the NC gradients of 2 pairs on a fixed
             K = 50 band (a random linear functional of the band NC output
             and the weak loss's positive term), float32 through the
             kernels against the plain band layer in float64, gated as
             (9a); (b) 3 Adam steps of make_train_step at batch 16,
             bfloat16 (the counts set to 0 just before): finite float32
             losses, float32 masters and Adam state, the NC weights moved,
             the trunk unchanged, and exactly 12 band forward, 8 dx and 12
             dw launches a step and no conv4d launch; one step's stage
             times (trunk, correlation + MM + top-K, band NC forward, band
             MM + score + loss, backward split into dx, dw and the rest,
             Adam) and the peak memory; (c) one float32 step at 192 px on
             the complete band (K = 144) against the dense step from the
             same weights: loss and NC gradients agree; (d) the synthetic
             convergence run trained and scored on a K = 16 band, gated as
             (10a): the loss falls, PCK@0.15 after training clears PCK
             before and the diagonal's by SYNTH_MARGIN; (e) ``python -m
             ncnet_tpu_torch.train --synthetic --allow_random_fe --nc_topk
             50 --max-steps 3``: its launches and its checkpoint's band.
10. eval   — (a) the synthetic convergence run (``ncnet_tpu_torch.eval.
             synthetic.run``) at its defaults (patch16, identity NC init,
             centred features, NC 3-3 / 16-1, 128 px, lr 5e-4, 400 steps,
             PCK@0.15), in float32 and in bfloat16, through the kernels:
             the loss must fall and PCK after training must clear both
             PCK before and the degenerate diagonal's by SYNTH_MARGIN;
             (b) PF-Pascal PCK at the PF-Pascal config (centred features)
             on PF_PAIRS generated keypointed pairs
             (``pf_pascal_sample``, 'scnet'):
             ``evaluate`` (3 conv4d launches a batch), ``evaluate_serving``
             and ``pck_vs_topk`` at K = BAND_K (6 band launches a batch),
             each pair's PCK equal to the plain kernels' path, or where it
             differs, the kernel's readout the plain one up to ties.
11. inloc  — ``dump_matches`` at the reference's InLoc settings (3200 px,
             k_size 2, NC 3-3 / 16-1, bfloat16, both directions, softmax)
             on one generated 4032x3024 query and two 1600x1200 panos
             (.npy files and a shortlist .mat): the .mat is [1, 2, 15000,
             5] with finite coordinates in [0, 1] and 4 conv4d launches a
             pair; one pair's readout holds against the forward through
             the plain conv4d (float32 sums of the same bfloat16 inputs,
             rounded to bfloat16): offsets equal, correlation and scores
             within INLOC_TOL, each differing pick short of the plain best
             by no more than the two correlations differ (a tie at their
             error); the pair's stage times; each conv4d
             layer at the pooled [1, 100, 75, 75, 100] grid and its
             transpose against its plain version (TOL), repeated bitwise,
             timed beside its plain version and bound. Then the same dump
             through the device route (``device_preprocess`` and
             ``device_resize``: uint8 images, the panos upscaled and every
             image normalized on the card): its .mat against the host
             route's (the contract; the scores of the rows both hold within
             INLOC_TOL), one pair's correlation through the device route
             against the host route's by the tie gate above (each pick
             short of the best by at most twice their difference), the same
             launches, and each route's host, transfer and device time for
             the query and a pano. Then (``inloc_store``) the same dump
             through a gallery feature store (``feature_store_dir``), cold
             and warm: the trunk runs for the query and every pano, then for
             the query alone; the same launches; each .mat against the
             image route's (the device route's gate), its seconds a pair.
12. finetune — trunk fine-tuning (``--fe_finetune_params 1``: layer3's
             last bottleneck with the head) at the PF-Pascal config on a
             model of its own (seed 0): the first NC layer's dx (a 16->1
             contraction) at the step's shape, 32 samples on 25^4,
             bfloat16 (O = 1 tensor cores) and float32 (FFMA, also bit for
             bit the chain oracle), against its plain version, repeated
             bitwise, timed beside the plain version and the bound; the
             tail unit's gradients (its convs and all four BN tensors) of 2
             pairs through the kernels against the plain route in float64
             (gated as 9a); FT_BF16_STEPS bfloat16 and FT_F32_STEPS float32
             steps at batch 16 (the counts set to 0 just before): finite
             losses, the first equal to the frozen-trunk loss on the same
             batch and weights (bitwise, or within SERVE_TOL), the tail
             moved, every other trunk tensor bitwise unchanged, 6 conv4d
             forward, 6 dx and 6 dw launches a step; the step's stages
             (trunk forward with its grad tail, pipeline forward and loss,
             backward with the first layer's dx and the tail's backward
             inside it, Adam) and peak memory.
13. finetune_band — the same at ``--nc_topk 50``: the band dx of the
             first band layer (16 into 1) on one training batch's K = 50
             band, both passes, against ``band_dx_plain``, repeated
             bitwise; the tail's gradients with the band's selection held
             fixed; 12 band forward, 12 dx and 12 dw launches a step and no
             conv4d launch.
14. trunks — VGG-16 and DenseNet-201 at 400 px (NC 5-5-5 / 16-16-1): a
             float32 4-pair serving batch through the kernels against the
             plain conv4d (every pair's readouts up to ties), the trunk's
             ms a batch of 8 images, and a bfloat16 training step at batch
             16 with the trunk frozen and one with its last tail unit
             trainable, finite losses and 15 / 10 / 12 conv4d launches.
15. stream — the streamed band (``corr_impl='stream'``) against the dense
             band at band training's shape (16 pairs, 25x25, c = 1024, K =
             50), mutual on and off, tiles 128 and 96, float32: bitwise the
             band of the correlation built from the same slabs (gate a);
             against ``correlation_4d``'s band, values within STREAM_RTOL /
             STREAM_ATOL where the indices agree and every index swap a
             near tie (gate b); a bitwise repeat; bfloat16 at tile 128
             (gate a); one InLoc-sized pair (200x150 against 150x200, K =
             16, both selections) by gate (b); each route's ms and peak
             memory; the stream's gradient against the dense band's
             autograd at batch 2 (STREAM_GRAD_TOL).
16. train_stream — 3 bfloat16 steps at batch 16 with ``--nc_topk 50
             --corr-impl stream`` against ``--corr-impl dense`` from the
             same weights (losses within TRAIN_STREAM_LOSS_TOL, the NC
             weights moved, 12 / 8 / 12 band launches a step), then one
             ``--fe_finetune_params 1`` step whose backward runs through
             the stream's VJP into the trunk (12 / 12 / 12).
17. refine — coarse-to-fine refinement at the PF-Pascal config (``--refine
             5 --refine_topk 16`` at 400 px): factor 1, radius 0 bitwise
             the K = 16 band (dense and streamed); the ServeEngine ladder
             (refined, standard, degraded) with requests pinned to each
             rung, refined batches served, the ladder one rung a flip under
             a burst; PF-Pascal PCK with ``--refine 5`` on the generated
             pairs, readouts against the plain band layer's up to ties,
             beside the dense eval; the band kernels on the refined paths'
             coarse bands against their plain versions; 3 refined bfloat16
             training steps at batch 16; the InLoc dump at 3200 px with
             ``--k_size 1 --refine 2`` (its .mat, 4 band launches a pair);
             stage seconds and peak memory.
18. checkpoint — a torchvision-keyed ResNet-101 state dict (random values
             from the seed, ``layer4`` and ``fc`` included) saved with
             ``torch.save``; 2 steps at batch 16 through the train CLI's
             ``main`` with ``--fe_weights`` (6 / 4 / 6 conv4d launches a
             step), whose ``.npz`` holds that trunk bitwise; then 8 requests
             from the ``.npz`` through the serve CLI's ``main`` with
             ``--checkpoint``, one a batch, against ``make_match_fn`` on
             ``convert.load_model``'s model (up to ties), and at
             ``--max-batch 4`` for the served pairs/s.
19. feature_cache — ``train`` (32 pairs) and ``val`` (16) feature stores
             at 400 px (ResNet-101 to layer3, bfloat16: 96 shards of 1.28
             MB) populated through the train CLI's ``open_feature_cache``;
             3 cached steps at batch 16 dense, at K = 50 (dense and streamed
             selection) and dense pinned on the card: no trunk call, 6 / 4 /
             6 conv4d or 12 / 8 / 12 band launches a step, the pinned losses
             bitwise the unpinned, each loss within CACHE_LOSS_TOL of the
             image path's; the stage times of a dense and a band step,
             cached and from images; a cached eval step; the stores re-opened
             under another trunk raise ``FeatureCacheMismatch``.
20. feature_store_serve — 16 requests over 8 images served from a gallery
             store (the serve CLI's ``feature_store_prep``), each pinned to
             the standard and the degraded (K = 16) program, twice (the
             trunk runs 8 times, then never): the standard rung's matches
             against the image path's up to ties, the degraded rung's bands
             against the image path's (every differing row holds a near
             tie), launches and pairs/s.
Then the ``{"kernels": [...]}`` line (``launches_by_path`` per kernel:
serve, serve_band, train, eval, inloc, inloc_device_route, train_band,
synthetic_band, finetune, finetune_band, trunks, and the later slices'
train_stream, finetune_stream, refine_serve, refine_eval, refine_train,
refine_inloc, checkpoint_train, checkpoint_serve, feature_cache,
feature_cache_band, feature_store_serve, inloc_store), the nvidia-smi line,
and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line. Needs one card; exits non-zero without CUDA.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense), the bounds built on
# them, CUDA-event times and the dw kernel's pass times: one module for
# this script and the kernel check scripts. Work held to float32 accuracy
# is bounded at the split-TF32 rate: the TF32 peak over the three MMAs a
# product of the conv4d kernels' float32 routes (csrc/mma_tf32.cuh),
# faster than FP32 FFMA on the CUDA cores (67 TFLOP/s).
from ncnet_tpu_torch.kernels.measure import (  # noqa: E402
    PEAK_BYTES,
    PEAK_FLOPS,
    TRACE_TRIES,
    bound_ms,
    dw_bound_ms,
    dw_passes_ms,
    dw_trace,
    ffma_bound_ms,
    time_ms,
)

SEED = 0
BAND_K = 16  # the degraded program's band width (scripts/serve.py --degrade 16)
MAX_BATCH = 4
N_SQUARE, N_RECT = 8, 4
SQUARE_HW, RECT_HW = (400, 400), (304, 400)
# PF-Pascal NC layers at 400 px: 25^4 grid, 5^4 kernels, (cin, cout)
NC_LAYERS = ((1, 16), (16, 16), (16, 1))
GRID, KSIZE = 25, 5
# kernel vs plain on the card: float32 sums of up to 10,000 products in
# two orders (cuDNN may use Winograd/FFT for the plain conv3d); bfloat16
# adds the output's rounding (2^-8 relative). Relative to max |plain|.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# band kernel vs plain on the card: float32 sums of at most 10,000
# products in two orders; bfloat16 adds the rounding of the product and of
# the biased sum (2^-8 relative each). Relative to max |plain|.
BAND_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# served corr, kernel vs plain forward, relative to max |corr|
SERVE_TOL = 1e-4
# dx kernel vs plain: the forward kernel's sums and rounding (as TOL); dw
# kernel vs plain: float32 sums of up to 781,250 products (2 samples) in
# other orders, bfloat16 held to 1e-2 of max |dw| as the forward's TOL
DW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# NC gradients, float32 through the kernels vs the plain conv4d in
# float64, relative to the max |g| of each layer's parameters. A float32
# forward flips some ReLUs against float64 and the backward sums of 1.56 M
# products cancel heavily, so the plain version in float32 (cuDNN) is
# itself up to 1.7e-3 (linear objective) and 8e-5 (score) of the scale off
# the float64 answer on an H100: the kernels are held to GRAD_RATIO times
# the plain float32 version's own error, or GRAD_TOL of the scale where
# that is larger. A wrong gradient is off by its own size.
GRAD_TOL = 1e-4
GRAD_RATIO = 4.0
TRAIN_BATCH = 16  # scripts/train.py --batch_size default
TRAIN_SAMPLES = 2 * TRAIN_BATCH  # one pipeline call, both directions batched
TRAIN_STEPS = 3
# 768 px: the 48x48 grid on which dw stages windows of k-rows
WIDE_HW, WIDE_GRID = (768, 768), 48
# float32 dw shapes at the route's edges, (x shape [b, i, j, k, l], ks,
# cin, cout): those the route before split-TF32 refused (C4), on small
# grids: `--ncons_kernel_sizes 5 5 5 --ncons_channels 16 64 1`'s 16->64
# layer, a 64->16 layer and 7^4 32->16; and the 1->16 layer at an odd count
# of positions (its one-channel x copy ends 8 bytes past a 16-byte
# boundary unless rounded up, and the g copy after it is read by cp.async)
DW_EDGE_SHAPES = (((2, 6, 7, 9, 11), 5, 16, 64), ((2, 7, 6, 11, 9), 5, 64, 16),
                  ((2, 6, 5, 9, 10), 7, 32, 16), ((1, 5, 5, 5, 5), 5, 1, 16),
                  ((1, 25, 25, 25, 25), 5, 1, 16))
# the libraries whose bfloat16 route runs on the tensor cores, and the one
# whose float32 route does (split-TF32) where its shape rule says so
BF16_TC_ROUTES = ("conv4d_fwd", "conv4d_dw", "band_gemm_dw", "band_gemm_dx")
TF32X3_ROUTES = ("conv4d_fwd", "conv4d_dw")
# the library whose float32 route keeps one input or one output channel on
# the CUDA cores, in these two kernel functions (no HMMA: other_mma above)
FFMA_ROUTES = ("conv4d_fwd",)
FFMA_FUNCTIONS = ("conv4d_fwd_ffma_c1", "conv4d_fwd_ffma_o1")
# eval: synthetic convergence at its defaults (128 px, patch16, identity NC
# init, NC 3-3 / 16-1, 400 steps): PCK@0.15 after training must clear PCK
# before and the degenerate diagonal's by SYNTH_MARGIN (a model collapsed
# onto the diagonal scores the baseline exactly; 0.1 is 26 of the 256
# query points)
SYNTH_MARGIN = 0.10
# the kernels' shapes in that run: a pipeline call of its 8-pair batch
# (training and scoring alike) batches both directions, 16 samples of the
# 8x8 grid of 128 px, NC 3-3 / 16-1; layer 1's input is the correlation,
# so dx runs for the 16 -> 1 layer only
SYNTH_SHAPE, SYNTH_KS = (16, 8, 8, 8, 8), 3
SYNTH_LAYERS = ((1, 16), (16, 1))
PF_PAIRS = 8  # generated keypointed PF-Pascal pairs, two batches of MAX_BATCH
# inloc: the reference's settings (eval_inloc.py: 3200 px, k_size 2, NC
# 3-3 / 16-1, bfloat16); an iPhone 7 query against 1600x1200 panos
INLOC_SIZE, INLOC_K = 3200, 2
QUERY_HW, PANO_HW = (4032, 3024), (1200, 1600)
INLOC_SLOTS = 15000  # n_match_slots(3200, 2, both directions)
INLOC_LAYERS = ((1, 16), (16, 1))
# the bfloat16 forward through the kernel vs the same forward through the
# plain conv4d in float32 on the same bfloat16 inputs, rounded to
# bfloat16 as the kernel rounds its float32 sums; relative to the scale
# of the plain correlation (and the softmax scores to theirs). The two
# sums differ in order only, so a layer's outputs differ by at most one
# bfloat16 step (2^-8 of the scale) where a sum lies at a rounding
# boundary; the post-NC mutual matching, a product of three factors in
# bfloat16, triples that and adds its own roundings
INLOC_TOL = 3e-2
# band training (scripts/train.py --nc_topk 50; README "Sparse neighbourhood
# consensus"): the K = 50 mutual band at the PF-Pascal config, batch 16,
# bfloat16; 25 x 50 = 1,250 candidates a cell, past the band kernels'
# 1,024-candidate tile
TRAIN_K = 50
# the complete band of 192 px (12x12 grids), against dense training
FULL_K_HW = (192, 192)
# the synthetic convergence run trained and scored on a K = 16 band of its
# 8x8 grids (64 cells)
SYNTH_BAND_K = 16
# band dx and dw kernels vs their plain versions on the card: float32
# reference sums of the same bfloat16 inputs in other orders; the kernels
# round each result once to bfloat16 (2^-8 relative). Relative to max
# |plain|.
BAND_GRAD_TOL = 1e-2
# full-K band training vs dense training, one float32 step: the weak loss is
# the difference of two scores of about 1/144 that cancel to about 1.3e-7
# (H100), so float32 sums in other orders move it by a few float32 steps of
# the scores (a step of 1/144 is 4.1e-10; the card's gaps were 9.3e-10 and
# 1.9e-9; the CPU run of the same check: 0). 1e-8 is about 24 such steps,
# and under a tenth of the loss. The step's NC gradients are held by their relative L2
# error a layer: float32 sums in other orders put an output of the last
# layer that is near 0 on the other side of its ReLU now and then, which
# moves a few of that layer's gradient elements by up to 1% of its max
# (CPU runs at 64 px: L2 2.7e-3; at 192 px: under 2e-5); a wrong backward
# is off by its own size.
# trunk fine-tuning (--fe_finetune_params): the last layer3 bottleneck
# trains with the head; 3 bfloat16 steps, then 1 float32 step
FT_BLOCKS = 1
FT_BF16_STEPS, FT_F32_STEPS = 3, 1
FULL_K_LOSS_TOL = 1e-8
FULL_K_GRAD_TOL = 1e-2
# the streamed band (--corr-impl stream): B-tile widths at band training's
# shape (128, the default, and 96, which does not divide 625 cells), and
# the InLoc grid at 3200 px (k_size 1) with the band of --refine_topk 16
STREAM_TILES = (128, 96)
INLOC_GRID, INLOC_BAND_K = (200, 150), 16
# gate (b): the band against correlation_4d's, float32's starting tolerance
# on the values of rows whose indices agree (cuBLAS may sum a 128-column
# slab in another order than the full GEMM: a few float32 steps)
STREAM_RTOL, STREAM_ATOL = 1e-5, 1e-6
# the stream's gradient against the dense band's autograd, float32: the
# correlation's cotangent summed in another order (three routes into a
# cell, then two GEMMs against the dense scatter-add and its GEMMs), of
# each gradient's scale; the same bound as GRAD_TOL
STREAM_GRAD_TOL = 1e-4
# 3 bfloat16 band steps, stream against dense, from the same weights: the
# weak loss is a difference of two mean best-match scores in [0, 1]; a
# bfloat16 slab summed in another order moves a band value by one step
# (2^-8 of it) and may swap a near tie at the band's edge, which moves a
# score by a few such steps on a few of 16 x 625 cells
TRAIN_STREAM_LOSS_TOL = 1e-3
# refinement at 400 px: the 25-cell grid pooled by 5 (bench.py's advice),
# the coarse band 16 of 25 cells; serving: requests pinned to each rung,
# then a burst of unpinned ones under a low high-water mark
REFINE_PF, REFINE_TOPK = 5, 16
REFINE_PINNED, REFINE_BURST = 4, 32
# this slice: requests served from a trained checkpoint (one a batch, then
# batched); the feature cache's stores (pairs) at the PF-Pascal config
CKPT_SERVE_REQUESTS = 8
CACHE_TRAIN_PAIRS, CACHE_VAL_PAIRS = 32, 16
# a cached step's loss against the image path's on the same batch and
# weights: the store's bfloat16 features come from trunk calls of 16 images
# (8 pairs' sources and targets), the image path's from calls of 16
# sources or 16 targets, so cuDNN may pick another algorithm and move a
# feature by one bfloat16 step (2^-8 of it) now and then; the loss, a
# difference of two mean best-match scores in [0, 1], then moves by a few
# such steps on a few cells (TRAIN_STREAM_LOSS_TOL's reasoning)
CACHE_LOSS_TOL = 1e-3
# serving from a gallery store: requests over a few images, each image
# visited by several requests
STORE_IMAGES = 8


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build(kernels):
    """Build every kernel, one nvcc each, all started together; count each
    library's tensor-core instructions."""
    from ncnet_tpu_torch.kernels._build import tensor_core_summary

    t0 = time.perf_counter()
    done, errors = {}, {}

    def one(name, kernel):
        try:
            log = kernel.load()
            done[name] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln],
            }
        except Exception as exc:  # reported below, then the run fails
            errors[name] = repr(exc)
            return
        counts = kernel.tensor_core_counts()
        if counts is None:
            done[name]["tensor_cores"] = "cuobjdump absent: not counted"
            return
        summary = tensor_core_summary(counts)
        done[name]["tensor_cores"] = {**summary, "per_function": counts}
        if name in BF16_TC_ROUTES and summary["bf16_route_min_mma"] == 0:
            errors[name] = (f"the bfloat16 route has no tensor-core "
                            f"instruction in some function: {counts}")
        if name in TF32X3_ROUTES and (summary["tf32x3_route_functions"] == 0
                                      or summary["tf32x3_route_min_mma"] == 0):
            errors[name] = (f"the split-TF32 route has no tensor-core "
                            f"instruction in some function: {counts}")
        if name in BF16_TC_ROUTES and summary["other_mma"] != 0:
            errors[name] = (f"a CUDA-core (FFMA) function holds tensor-core "
                            f"instructions: {counts}")
        if name in FFMA_ROUTES and not all(
                any(fn_name in fn for fn in counts) for fn_name in FFMA_FUNCTIONS):
            errors[name] = (f"the float32 FFMA route lacks one of "
                            f"{FFMA_FUNCTIONS}: {counts}")

    threads = [threading.Thread(target=one, args=item) for item in kernels.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": done, "errors": errors})
    if errors:
        raise RuntimeError(f"kernel build failed: {errors}")


def nc_inputs(shape, cin, cout, dtype, seed, ks=KSIZE):
    """Post-ReLU-like activations in [0, 1) and reference-init weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bound = (cin * ks**4) ** -0.5
    x = torch.rand(*shape, cin, generator=g, device="cuda")
    w = (torch.rand(ks, ks, ks, ks, cin, cout, generator=g,
                    device="cuda") * 2 - 1) * bound
    b = (torch.rand(cout, generator=g, device="cuda") * 2 - 1) * bound
    return x.to(dtype), w.to(dtype), b


def ffma_oracle_bitwise(conv4d_fwd, got, x, w, b=None):
    """Whether ``got`` (an FFMA-route output of the kernel on ``x, w, b``)
    holds the chain oracle's bits exactly: one fmaf chain an output in (di,
    dj, dk, dl, c) order from +0, the bias last."""
    want = conv4d_fwd.chain_oracle(x.float(), w.float(), b)
    return bool(torch.equal(got.float(), want))


def host_ms(fn, reps):
    """Mean host time of one call of ``fn``: the wall time of ``reps``
    calls issued back to back, before the card is waited for. Where it
    exceeds the device time, the card idles between the launches."""
    fn()  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return 1e3 * host


def device_ms(fn, key, reps):
    """Mean device time of the kernels whose name holds ``key`` over
    ``reps`` calls of ``fn``, from ``torch.profiler``'s CUDA trace, or
    None where the trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                if key in e.key)
    return total / reps / 1e3 if total > 0 else None


def phase_kernels(smi, conv4d_fwd, conv4d_plain):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = GRID
    from ncnet_tpu_torch.kernels.conv4d import route

    cases = [((4, g, g, g, g), cin, cout) for cin, cout in NC_LAYERS]
    cases += [((4, g, g, 19, g), 16, 16), ((4, g, g, 19, g), 1, 16),
              ((4, g, g, 19, g), 16, 1), ((2, 3, 2, 4, 3), 1, 16),
              ((2, 3, 2, 4, 3), 16, 1)]
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (shape, cin, cout) in enumerate(cases):
            x, w, b = nc_inputs(shape, cin, cout, dtype, seed=ci)
            got = conv4d_fwd(x, w, b).float()
            want = conv4d_plain(x.float(), w.float(), b)
            # the FFMA route keeps the chain oracle's bits exactly
            oracle = (ffma_oracle_bitwise(conv4d_fwd, got, x, w, b)
                      if route(dtype, cin, cout) == "ffma" else None)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = (bool(torch.isfinite(got).all()) and err <= TOL[dtype] * scale
                  and oracle is not False)
            checks.append({"shape": list(shape), "cin": cin, "cout": cout,
                           "dtype": str(dtype).split(".")[1],
                           "max_abs_err": err, "max_rel_err": err / scale,
                           "tol_rel": TOL[dtype], "oracle_bitwise": oracle,
                           "ok": ok})
            if not ok:
                emit({"phase": "kernels", "checks": checks})
                raise AssertionError(f"conv4d kernel disagrees: {checks[-1]}")

    # per-layer times at the serving path's square batch: MAX_BATCH pairs,
    # both symmetric directions batched; each timed layer also held to TOL
    # against the plain version and to a bitwise repeat, with its route,
    # and an FFMA layer to the chain oracle's bits
    layers = []
    shape = (2 * MAX_BATCH, g, g, g, g)
    for li, (cin, cout) in enumerate(NC_LAYERS):
        x, w, b = nc_inputs(shape, cin, cout, torch.float32, seed=10 + li)
        ms = time_ms(lambda: conv4d_fwd(x, w, b), reps=3)
        plain_ms = time_ms(lambda: conv4d_plain(x, w, b), reps=3)
        got, again = conv4d_fwd(x, w, b), conv4d_fwd(x, w, b)
        want = conv4d_plain(x, w, b)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        bitwise = bool(torch.equal(got, again))
        built = conv4d_fwd.built_route(torch.float32, cin, cout)
        oracle = (ffma_oracle_bitwise(conv4d_fwd, got, x, w, b)
                  if built == "ffma" else None)
        bms, by, flops = bound_ms(shape, cin, cout, torch.float32, KSIZE)
        layers.append({"layer": li, "shape": list(shape), "cin": cin,
                       "cout": cout, "dtype": "float32", "route": built,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "ffma_bound_ms": ffma_bound_ms(flops),
                       "gflop": flops / 1e9,
                       "tflops": flops / ms / 1e9, "max_abs_err": err,
                       "max_rel_err": err / scale, "tol_rel": TOL[torch.float32],
                       "bitwise_repeat": bitwise, "oracle_bitwise": oracle})
        if not (bitwise and err <= TOL[torch.float32] * scale
                and built == route(torch.float32, cin, cout)
                and oracle is not False):
            emit({"phase": "kernels", "checks": checks, "timed": layers})
            raise AssertionError(f"timed float32 layer fails: {layers[-1]}")
    emit({"phase": "kernels", "card": smi,
          "checks": checks, "timed": layers})
    return layers


def build_model():
    """ImMatchNet at the PF-Pascal config, random weights from `SEED`."""
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig

    config = ImMatchNetConfig(
        feature_extraction_cnn="resnet101", ncons_kernel_sizes=(5, 5, 5),
        ncons_channels=(16, 16, 1), symmetric_mode=True,
    )
    model = ImMatchNet(config, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    return model, config


def image_maker(seed):
    """``image(hw)``: a random ImageNet-normalized ``[h, w, 3]`` image."""
    from ncnet_tpu_torch.data.images import normalize_image_np

    rng = np.random.RandomState(seed)

    def image(hw):
        return normalize_image_np(
            rng.uniform(0, 255, hw + (3,)).astype(np.float32)
        ).astype(np.float32)

    return image


def argmax_agrees(corr_k, corr_p):
    """Both readout directions of ``corr_k`` pick, on the plain forward's
    softmax, a score within SERVE_TOL of the plain best: equal argmax,
    allowing for (near-)ties in the plain scores."""
    from ncnet_tpu_torch.ops.matches import corr_to_matches

    flat_p = corr_p.reshape(1, corr_p.shape[1] * corr_p.shape[2], -1)
    ok = True
    for dim, invert in ((1, False), (2, True)):
        sm = torch.softmax(flat_p, dim=dim)
        i_k = corr_to_matches(corr_k, do_softmax=True, scale="positive",
                              invert_matching_direction=invert,
                              return_indices=True)
        ia, ja, ib, jb = i_k[5:]
        a_idx = ia * corr_p.shape[2] + ja
        b_idx = ib * corr_p.shape[4] + jb
        picked = sm[0, a_idx[0], b_idx[0]]
        best = sm.amax(dim=dim)[0]
        ok &= bool((picked >= best - SERVE_TOL * float(best.max())).all())
    return ok


def run_clients(engine, requests, payloads, variants=None):
    """Submit every request from 4 client threads; returns the futures."""
    futures = [None] * len(requests)

    def client(idx):
        for i in idx:
            futures[i] = engine.submit(
                key=requests[i], payload=payloads[i],
                **({} if variants is None else {"variant": variants[i]}),
            )

    clients = [threading.Thread(target=client, args=(range(c, len(requests), 4),))
               for c in range(4)]
    for t in clients:
        t.start()
    for t in clients:
        t.join()
    return futures


def check_matches(requests, results):
    for (src, tgt), res in zip(requests, results):
        m = res["matches"]
        # one match per B cell (forward) and per A cell (reverse)
        n = (tgt[0] // 16) * (tgt[1] // 16) + (src[0] // 16) * (src[1] // 16)
        if m.shape != (5, n) or not np.isfinite(m).all():
            raise AssertionError(f"bad matches {m.shape} (want (5, {n})) or non-finite")


def phase_serve(smi, model, config, conv4d_fwd, conv4d_plain):
    """Serve the PF-Pascal config; returns the kernel's launches over the
    served batches."""
    from ncnet_tpu_torch.models.immatchnet import immatchnet_apply
    from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
    from ncnet_tpu_torch.serve.step import make_match_fn, make_serve_match_step

    t0 = time.perf_counter()
    apply = make_serve_match_step(config)
    served_keys = []

    def counted_apply(m, batch):
        served_keys.append((tuple(batch["source_image"].shape[1:3]),
                            tuple(batch["target_image"].shape[1:3])))
        return apply(m, batch)

    image = image_maker(SEED)
    requests = [(SQUARE_HW, SQUARE_HW)] * N_SQUARE + [(SQUARE_HW, RECT_HW)] * N_RECT
    payloads = [{"source_image": image(s), "target_image": image(t)}
                for s, t in requests]
    with ServeEngine(counted_apply, model, device="cuda", max_batch=MAX_BATCH,
                     max_wait=0.05) as engine:
        t_warm = time.perf_counter()
        engine.warmup([((SQUARE_HW, SQUARE_HW), payload_spec(payloads[0])),
                       ((SQUARE_HW, RECT_HW), payload_spec(payloads[-1]))])
        warmup_s = time.perf_counter() - t_warm
        served_keys.clear()
        conv4d_fwd.launches = 0
        t_serve = time.perf_counter()
        futures = run_clients(engine, requests, payloads)
        results = [f.result(timeout=600) for f in futures]  # raises on a failed future
        serve_s = time.perf_counter() - t_serve
    launches = conv4d_fwd.launches
    report = engine.report()

    n_sq = sum(1 for k in served_keys if k == (SQUARE_HW, SQUARE_HW))
    n_rect = len(served_keys) - n_sq
    expected = 3 * n_sq + 6 * n_rect
    check_matches(requests, results)
    if report["failed"] or report["completed"] != len(requests):
        raise AssertionError(f"serving failed: {report}")
    if launches != expected or n_sq == 0 or n_rect == 0:
        raise AssertionError(
            f"conv4d launches {launches} != 3 x {n_sq} square + 6 x {n_rect} "
            "rectangular batches"
        )

    # one request of each bucket: the forward with the kernel against the
    # same forward with the plain conv4d, on the card
    agree = []
    match_fn = make_match_fn(config)
    for idx in (0, len(requests) - 1):
        src = torch.from_numpy(payloads[idx]["source_image"][None]).cuda()
        tgt = torch.from_numpy(payloads[idx]["target_image"][None]).cuda()
        with torch.inference_mode():
            # the served row is the same forward as this lone request
            lone = match_fn(model, src, tgt)[:, 0].cpu().numpy()
            served = results[idx]["matches"]
            served_err = float(np.abs(served[4] - lone[4]).max())
            served_ok = served_err <= SERVE_TOL * float(np.abs(lone[4]).max())
            corr_k = immatchnet_apply(model, config, src, tgt)
            conv = model.neigh_consensus.conv
            model.neigh_consensus.conv = conv4d_plain
            try:
                corr_p = immatchnet_apply(model, config, src, tgt)
            finally:
                model.neigh_consensus.conv = conv
            scale = float(corr_p.abs().max())
            corr_err = float((corr_k - corr_p).abs().max())
            idx_ok = argmax_agrees(corr_k, corr_p)
            ok = corr_err <= SERVE_TOL * scale and idx_ok and served_ok
        agree.append({"request": idx, "bucket": [list(requests[idx][0]), list(requests[idx][1])],
                      "served_vs_lone_score_err": served_err,
                      "corr_max_abs_err": corr_err, "corr_scale": scale,
                      "argmax_agree": idx_ok, "ok": ok})
        if not ok:
            raise AssertionError(f"kernel path disagrees with the plain path: {agree[-1]}")
    emit({"phase": "serve", "card": smi, "config": config.to_dict(),
          "requests": len(requests), "square_batches": n_sq,
          "rect_batches": n_rect, "conv4d_launches": launches,
          "expected_launches": expected, "setup_s": t_warm - t0,
          "warmup_s": warmup_s, "serve_s": serve_s,
          "pairs_per_s": report["pairs_per_s"],
          "latency_p50_ms": report["latency_p50_ms"],
          "latency_p95_ms": report["latency_p95_ms"],
          "mean_occupancy": report["mean_occupancy"], "agreement": agree,
          "stages_ms": stage_breakdown(model, config, payloads[:MAX_BATCH])})
    return launches


def stage_breakdown(model, config, payloads, reps=3):
    """CUDA-event times of the serving forward's stages on one square batch
    (``len(payloads)`` pairs), each timed alone after a warm-up."""
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.ops.matches import corr_to_matches
    from ncnet_tpu_torch.serve.step import make_serve_match_step

    batch = {k: torch.from_numpy(np.stack([p[k] for p in payloads])).cuda()
             for k in payloads[0]}
    apply = make_serve_match_step(config)
    with torch.inference_mode():
        fa = extract_features(model, config, batch["source_image"])
        fb = extract_features(model, config, batch["target_image"])
        corr = mutual_matching(correlation_4d(fa, fb))
        filtered = model.neigh_consensus(corr)

        def readout():
            c = mutual_matching(filtered).float()
            kw = dict(scale="positive", do_softmax=True)
            return torch.cat([torch.stack(corr_to_matches(c, **kw)),
                              torch.stack(corr_to_matches(
                                  c, invert_matching_direction=True, **kw))], 2)

        return {
            "pairs": len(payloads),
            "trunk": time_ms(lambda: (
                extract_features(model, config, batch["source_image"]),
                extract_features(model, config, batch["target_image"])), reps),
            "correlation_mm": time_ms(
                lambda: mutual_matching(correlation_4d(fa, fb)), reps),
            "neigh_consensus": time_ms(lambda: model.neigh_consensus(corr), reps),
            "mm_readout": time_ms(readout, reps),
            "forward": time_ms(lambda: apply(model, batch), reps),
        }


def real_band(b, grid_a, grid_b, k, seed):
    """A mutual top-``k`` band as the serving path builds one: L2-normalized
    non-negative random features, correlation, mutual matching, `topk_band`.
    Returns ``(values, indices)``."""
    from ncnet_tpu_torch.ops.band import topk_band
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.ops.norm import feature_l2norm

    g = torch.Generator(device="cuda").manual_seed(seed)
    fa = feature_l2norm(torch.rand(b, *grid_a, 1024, generator=g, device="cuda"))
    fb = feature_l2norm(torch.rand(b, *grid_b, 1024, generator=g, device="cuda"))
    corr = correlation_4d(fa, fb)
    return topk_band(corr, k, values_from=mutual_matching(corr), mutual=True)


def band_geometries(indices, grid_b):
    """The two passes' geometries of one band (the plain pass's, and the
    symmetric pass's over the B-major entries), as the NC stack makes them."""
    from ncnet_tpu_torch.ops.band import BandGeometry, b_major_order

    return {"plain": BandGeometry(indices, grid_b),
            "swapped": BandGeometry(indices, grid_b, *b_major_order(indices))}


@contextlib.contextmanager
def counting_pointer_builds():
    """Count the calls of ``ops.band.band_neighbor_pointers`` (every pointer
    table the port builds) inside the block: ``with ... as calls``,
    ``calls[0]`` after it."""
    from ncnet_tpu_torch.ops import band

    real, calls = band.band_neighbor_pointers, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    band.band_neighbor_pointers = counted
    try:
        yield calls
    finally:
        band.band_neighbor_pointers = real


def band_layer_inputs(b, n, cin, cout, dtype, seed):
    """Entries in [0, 1) and reference-init weights of one band layer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bound = (cin * KSIZE**4) ** -0.5
    x = torch.rand(b, n, cin, generator=g, device="cuda")
    w = (torch.rand(KSIZE, KSIZE, KSIZE, KSIZE, cin, cout, generator=g,
                    device="cuda") * 2 - 1) * bound
    bias = (torch.rand(cout, generator=g, device="cuda") * 2 - 1) * bound
    return x.to(dtype), w.to(dtype), bias


def band_bound_ms(geom, cin, cout, dtype):
    """The least time of one band layer's forward, dx or dw on the card:
    the FLOPs of this band's hits (the (entry, neighbour) pairs on the
    band, each a [cin] x [cout] product: the forward and dx contract the
    pairs that dw sums, counted by the card's hit list) over the peak of
    ``dtype``, against the bytes the kernel must move (the layer's input
    and output entry lists, the indices, ``inv`` on the symmetric pass,
    the weights and bias), each once. No pointer table: the kernels build
    none, and read no ``perm`` (the entries arrive permuted)."""
    b, ha, wa, k = geom.indices.shape
    n = ha * wa * k
    taps = KSIZE**4
    hits = geom.hits((KSIZE,) * 4).count
    elt = torch.finfo(dtype).bits // 8
    flops = 2.0 * hits * cin * cout
    nbytes = (b * n * (cin + cout) * elt + b * n * 4 * (2 if geom.swapped else 1)
              + taps * cin * cout * elt + 4 * cout)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "hits": hits, "hits_per_entry": hits / (b * n),
            "nonnull_share": hits / (b * n * taps),
            "gflop_nonnull": flops / 1e9,
            "gflop_all_taps": 2.0 * b * n * taps * cin * cout / 1e9,
            "mbytes": nbytes / 1e6}


def band_kernel_call(band_gemm_fwd, x, w, b, geom):
    """The band kernel's wrapper on one layer of a pass."""
    return band_gemm_fwd(x, w, b, geom.indices, geom.grid_b, geom.inv)


def phase_band_kernels(smi, band_gemm_fwd, band_plain):
    """The band kernel against its plain version on real bands; then each
    layer and pass timed at the served square batch."""
    g = GRID
    cases = []  # (label, geometry, cin, cout)
    _, idx = real_band(2, (g, g), (g, g), BAND_K, seed=20)
    for name, geom in band_geometries(idx, (g, g)).items():
        for cin, cout in NC_LAYERS:
            cases.append((f"25x25/25x25 K{BAND_K} {name}", geom, cin, cout))
    _, idx = real_band(2, (g, g), (19, g), BAND_K, seed=21)
    cases.append((f"25x25/19x25 K{BAND_K} swapped",
                  band_geometries(idx, (19, g))["swapped"], 16, 16))
    _, idx = real_band(2, (g, g), (g, g), 50, seed=22)
    cases.append(("25x25/25x25 K50 plain", band_geometries(idx, (g, g))["plain"],
                  16, 16))
    # the complete band of phase full_k's 192 px grids
    _, idx = real_band(2, (12, 12), (12, 12), 144, seed=24)
    for name, geom in band_geometries(idx, (12, 12)).items():
        cases.append((f"12x12/12x12 K144 {name}", geom, 16, 16))
    _, idx = real_band(2, (12, 12), (9, 12), 108, seed=25)
    cases.append(("12x12/9x12 K108 swapped",
                  band_geometries(idx, (9, 12))["swapped"], 1, 16))
    _, idx = real_band(2, (3, 2), (4, 3), 5, seed=23)
    tiny = band_geometries(idx, (4, 3))
    cases += [("3x2/4x3 K5 plain", tiny["plain"], 1, 16),
              ("3x2/4x3 K5 swapped", tiny["swapped"], 16, 1)]
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (label, geom, cin, cout) in enumerate(cases):
            n = geom.indices[0].numel()
            x, w, b = band_layer_inputs(geom.indices.shape[0], n, cin, cout,
                                        dtype, seed=ci)
            got = band_kernel_call(band_gemm_fwd, x, w, b, geom).float()
            want = band_plain(x.float(), w.float(), b.to(dtype).float(), geom)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= BAND_TOL[dtype] * scale
            checks.append({"case": label, "n": n, "cin": cin,
                           "cout": cout, "dtype": str(dtype).split(".")[1],
                           "max_abs_err": err, "max_rel_err": err / scale,
                           "tol_rel": BAND_TOL[dtype], "ok": ok})
            if not ok:
                emit({"phase": "band_kernels", "checks": checks})
                raise AssertionError(f"band kernel disagrees: {checks[-1]}")

    # per-layer, per-pass times at the served square batch (MAX_BATCH
    # pairs; the band runs its two symmetric passes one after the other)
    _, idx = real_band(MAX_BATCH, (g, g), (g, g), BAND_K, seed=30)
    geoms = band_geometries(idx, (g, g))
    layers = []
    for li, (cin, cout) in enumerate(NC_LAYERS):
        for name, geom in geoms.items():
            x, w, b = band_layer_inputs(MAX_BATCH, geom.indices[0].numel(), cin,
                                        cout, torch.float32, seed=40 + li)
            ms = time_ms(lambda: band_kernel_call(band_gemm_fwd, x, w, b, geom),
                         reps=20)
            dev_ms = device_ms(
                lambda: band_kernel_call(band_gemm_fwd, x, w, b, geom),
                "band_nc_fwd", reps=20)
            call_ms = host_ms(
                lambda: band_kernel_call(band_gemm_fwd, x, w, b, geom), reps=20)
            plain_ms = time_ms(lambda: band_plain(x, w, b, geom), reps=3)
            got = band_kernel_call(band_gemm_fwd, x, w, b, geom)
            bitwise = bool(torch.equal(
                band_kernel_call(band_gemm_fwd, x, w, b, geom), got))
            want = band_plain(x, w, b, geom)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = err <= BAND_TOL[torch.float32] * scale and bitwise
            layers.append({"layer": li, "pass": name, "shape": list(x.shape),
                           "cin": cin, "cout": cout, "dtype": "float32",
                           "ms": ms, "device_ms": dev_ms, "host_ms": call_ms,
                           "plain_ms": plain_ms,
                           "max_abs_err": err, "max_rel_err": err / scale,
                           "bitwise_repeat": bitwise,
                           "ok": ok, **band_bound_ms(geom, cin, cout, torch.float32)})
            if not ok:
                emit({"phase": "band_kernels", "checks": checks, "timed": layers})
                raise AssertionError(
                    f"band kernel disagrees at the served batch: {layers[-1]}")
    emit({"phase": "band_kernels", "card": smi, "checks": checks,
          "timed": layers})
    return layers


def phase_serve_band(smi, model, config, conv4d_fwd, band_gemm_fwd, band_plain):
    """Serve with a dense standard and a K-band degraded program; returns
    the band kernel's launches over the served batches."""
    from ncnet_tpu_torch.models.immatchnet import immatchnet_apply
    from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
    from ncnet_tpu_torch.serve.step import make_match_fn, make_serve_match_step

    band_config = config.replace(nc_topk=BAND_K)
    served = []  # (program, key, first pixel of each row) per batch run

    def recording(apply, name):
        def fn(m, batch):
            src = batch["source_image"]
            served.append((name, (tuple(src.shape[1:3]),
                                  tuple(batch["target_image"].shape[1:3])),
                           src[:, 0, 0, 0].clone()))
            return apply(m, batch)
        return fn

    image = image_maker(SEED + 1)
    requests = [(SQUARE_HW, SQUARE_HW)] * 5 + [(SQUARE_HW, RECT_HW)] * 3 \
        + [(SQUARE_HW, SQUARE_HW)] * 2
    variants = ["degraded"] * 8 + [None] * 2
    payloads = [{"source_image": image(s), "target_image": image(t)}
                for s, t in requests]
    with ServeEngine(recording(make_serve_match_step(config), "standard"), model,
                     device="cuda", max_batch=MAX_BATCH, max_wait=0.05,
                     degraded_apply_fn=recording(
                         make_serve_match_step(band_config), "degraded"),
                     ) as engine:
        t_warm = time.perf_counter()
        engine.warmup([((SQUARE_HW, SQUARE_HW), payload_spec(payloads[0])),
                       ((SQUARE_HW, RECT_HW), payload_spec(payloads[5]))])
        warmup_s = time.perf_counter() - t_warm
        served.clear()
        with counting_pointer_builds() as tables:
            conv4d_fwd.launches = band_gemm_fwd.launches = 0
            t_serve = time.perf_counter()
            futures = run_clients(engine, requests, payloads, variants)
            results = [f.result(timeout=600) for f in futures]  # raises on a failed future
            serve_s = time.perf_counter() - t_serve
            band_launches, conv_launches = band_gemm_fwd.launches, conv4d_fwd.launches
    report = engine.report()

    check_matches(requests, results)
    n_deg = sum(1 for name, _, _ in served if name == "degraded")
    n_std_sq = sum(1 for name, key, _ in served
                   if name == "standard" and key == (SQUARE_HW, SQUARE_HW))
    n_std_rect = len(served) - n_deg - n_std_sq
    if report["failed"] or report["completed"] != len(requests):
        raise AssertionError(f"serving failed: {report}")
    if n_deg == 0 or report["degraded_batches"] != n_deg:
        raise AssertionError(f"degraded batches {n_deg}, report {report}")
    if band_launches != 6 * n_deg:
        raise AssertionError(
            f"band launches {band_launches} != 6 x {n_deg} degraded batches")
    if tables[0] != 0:
        raise AssertionError(
            f"the served band batches built {tables[0]} pointer tables; the "
            "kernel derives its taps from the band and needs none")
    if conv_launches != 3 * n_std_sq + 6 * n_std_rect:
        raise AssertionError(
            f"conv4d launches {conv_launches} != 3 x {n_std_sq} square + 6 x "
            f"{n_std_rect} rectangular standard batches")

    # one degraded request of each bucket: the served row against the same
    # request's band forward at the served batch's padded size (the trunk's
    # float32 sums change with the batch size at the ulp level, which can
    # swap near-tied entries at the band's edge), and the band forward with
    # the kernel against the same forward with the plain band layer
    agree = []
    match_fn = make_match_fn(band_config)
    for idx in (0, 5):
        pixel = float(payloads[idx]["source_image"][0, 0, 0])
        (bs,) = [len(rows) for name, _, rows in served if name == "degraded"
                 and bool((rows == pixel).any())]
        src = torch.from_numpy(payloads[idx]["source_image"][None]).cuda()
        tgt = torch.from_numpy(payloads[idx]["target_image"][None]).cuda()
        with torch.inference_mode():
            lone = match_fn(model, src.repeat(bs, 1, 1, 1),
                            tgt.repeat(bs, 1, 1, 1))[:, 0].cpu().numpy()
            served_err = float(np.abs(results[idx]["matches"][4] - lone[4]).max())
            served_ok = served_err <= SERVE_TOL * float(np.abs(lone[4]).max())
            corr_k = immatchnet_apply(model, band_config, src, tgt)
            layer = model.neigh_consensus.band_layer
            model.neigh_consensus.band_layer = band_plain
            try:
                corr_p = immatchnet_apply(model, band_config, src, tgt)
            finally:
                model.neigh_consensus.band_layer = layer
            scale = float(corr_p.abs().max())
            corr_err = float((corr_k - corr_p).abs().max())
            idx_ok = argmax_agrees(corr_k, corr_p)
            ok = corr_err <= SERVE_TOL * scale and idx_ok and served_ok
        agree.append({"request": idx, "bucket": [list(requests[idx][0]),
                                                 list(requests[idx][1])],
                      "served_batch": bs, "served_vs_same_batch_score_err": served_err,
                      "corr_max_abs_err": corr_err, "corr_scale": scale,
                      "argmax_agree": idx_ok, "ok": ok})
        if not ok:
            raise AssertionError(f"band kernel path disagrees with the plain path: {agree[-1]}")
    emit({"phase": "serve_band", "card": smi, "config": band_config.to_dict(),
          "requests": len(requests), "pinned_degraded": variants.count("degraded"),
          "degraded_batches": n_deg, "standard_square_batches": n_std_sq,
          "standard_rect_batches": n_std_rect, "band_launches": band_launches,
          "pointer_tables_built": tables[0],
          "conv4d_launches": conv_launches, "warmup_s": warmup_s,
          "serve_s": serve_s, "pairs_per_s": report["pairs_per_s"],
          "latency_p50_ms": report["latency_p50_ms"],
          "latency_p95_ms": report["latency_p95_ms"],
          "degrade_flips": report["degrade_flips"], "agreement": agree,
          "stages_ms": band_stage_breakdown(model, band_config,
                                            payloads[:MAX_BATCH])})
    return band_launches


def band_stage_breakdown(model, config, payloads, reps=3):
    """CUDA-event times of the band serving forward's stages on one square
    batch (``len(payloads)`` pairs), each timed alone after a warm-up. The
    NC stage builds no pointer table (its kernel derives the taps from the
    band): the stages are timed under a call counter on
    ``band_neighbor_pointers``, which must read 0."""
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.ops.band import topk_band
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.ops.matches import corr_to_matches
    from ncnet_tpu_torch.serve.step import make_serve_match_step
    from ncnet_tpu_torch.sparse import (
        band_mutual_matching,
        resolve_band_width,
        sparse_corr_to_dense,
        sparse_neigh_consensus_apply,
    )

    batch = {k: torch.from_numpy(np.stack([p[k] for p in payloads])).cuda()
             for k in payloads[0]}
    apply = make_serve_match_step(config)
    params = model.neigh_consensus.params()
    with torch.inference_mode():
        fa = extract_features(model, config, batch["source_image"])
        fb = extract_features(model, config, batch["target_image"])
        grid_b = (fb.shape[1], fb.shape[2])
        k = resolve_band_width(config.nc_topk, grid_b)

        def select():
            corr = correlation_4d(fa, fb)
            return topk_band(corr, k, values_from=mutual_matching(corr),
                             mutual=config.nc_topk_mutual)

        values, indices = select()

        def nc():
            return sparse_neigh_consensus_apply(
                params, values, indices, grid_b, symmetric=config.symmetric_mode)

        band = nc()

        def readout():
            c = sparse_corr_to_dense(
                band_mutual_matching(band, indices, grid_b).float(), indices, grid_b)
            kw = dict(scale="positive", do_softmax=True)
            return torch.cat([torch.stack(corr_to_matches(c, **kw)),
                              torch.stack(corr_to_matches(
                                  c, invert_matching_direction=True, **kw))], 2)

        with counting_pointer_builds() as tables:
            stages = {
                "pairs": len(payloads),
                "trunk": time_ms(lambda: (
                    extract_features(model, config, batch["source_image"]),
                    extract_features(model, config, batch["target_image"])), reps),
                "corr_mm_topk": time_ms(select, reps),
                "neigh_consensus": time_ms(nc, reps),
                "band_mm_readout": time_ms(readout, reps),
                "forward": time_ms(lambda: apply(model, batch), reps),
            }
    if tables[0] != 0:
        raise AssertionError(f"the band forward built {tables[0]} pointer tables")
    return {**stages, "pointer_tables_built": tables[0]}


def phase_full_k(smi, model, config, conv4d_fwd, band_gemm_fwd):
    """At 192 px the complete band (K = hB*wB) through the band kernel
    equals the dense forward through the conv4d kernel."""
    from ncnet_tpu_torch.models.immatchnet import immatchnet_apply

    image = image_maker(SEED + 2)
    checks = []
    for tgt_hw in ((192, 192), (144, 192)):
        src = torch.from_numpy(np.stack([image((192, 192)) for _ in range(2)])).cuda()
        tgt = torch.from_numpy(np.stack([image(tgt_hw) for _ in range(2)])).cuda()
        k = (tgt_hw[0] // 16) * (tgt_hw[1] // 16)
        conv0, band0 = conv4d_fwd.launches, band_gemm_fwd.launches
        with torch.inference_mode():
            dense = immatchnet_apply(model, config, src, tgt)
            band = immatchnet_apply(model, config.replace(nc_topk=k), src, tgt)
        scale = float(dense.abs().max())
        err = float((band - dense).abs().max())
        launched = (conv4d_fwd.launches - conv0, band_gemm_fwd.launches - band0)
        ok = err <= SERVE_TOL * scale and launched[1] == 6 and launched[0] > 0
        checks.append({"source_hw": [192, 192], "target_hw": list(tgt_hw),
                       "k": k, "max_abs_err": err, "scale": scale,
                       "conv4d_launches": launched[0],
                       "band_launches": launched[1], "ok": ok})
        if not ok:
            emit({"phase": "full_k", "checks": checks})
            raise AssertionError(f"full-K band != dense: {checks[-1]}")
    emit({"phase": "full_k", "card": smi, "tol_rel": SERVE_TOL, "checks": checks})


def phase_train_kernels(smi, kernels, fwd_plain, dx_plain, dw_plain):
    """The dx and dw kernels against their plain versions at every training
    layer shape, float32 and bfloat16; then the forward, dx and dw timed at
    the training batch, each held to its tolerance, the forward and dw to
    a bitwise repeat. Returns ``(fwd_layers, dx_layers, dw_layers)`` of
    timed records."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = GRID
    dx_layers = NC_LAYERS[1:]  # layer 1's input is the correlation: no dx
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for li, (cin, cout) in enumerate(NC_LAYERS):
            shape = (2, g, g, g, g)
            x, w, _ = nc_inputs(shape, cin, cout, dtype, seed=50 + li)
            gr = torch.randn(*shape, cout, device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(60 + li)).to(dtype)
            results = [("dw", kernels["conv4d_dw"](x, gr, KSIZE),
                        dw_plain(x, gr, KSIZE), DW_TOL[dtype])]
            if (cin, cout) in dx_layers:
                results.append(("dx", kernels["conv4d_dx"](gr, w).float(),
                                dx_plain(gr.float(), w.float()), TOL[dtype]))
            torch.cuda.synchronize()
            for name, got, want, tol in results:
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                ok = bool(torch.isfinite(got).all()) and err <= tol * scale
                checks.append({"kernel": name, "layer": li, "cin": cin,
                               "cout": cout, "dtype": str(dtype).split(".")[1],
                               "max_abs_err": err, "max_rel_err": err / scale,
                               "tol_rel": tol, "ok": ok})
                if not ok:
                    emit({"phase": "train_kernels", "checks": checks})
                    raise AssertionError(f"conv4d {name} kernel disagrees: {checks[-1]}")

    # per-layer times at the training batch, in the training path's dtype
    dtype = torch.bfloat16
    shape = (TRAIN_SAMPLES, g, g, g, g)
    timed = {"fwd": [], "dx": [], "dw": []}
    for li, (cin, cout) in enumerate(NC_LAYERS):
        x, w, b = nc_inputs(shape, cin, cout, dtype, seed=70 + li)
        gr = torch.randn(*shape, cout, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(80 + li)).to(dtype)
        # (name, kernel, plain version as timed, reference as in the
        # 2-sample checks, tolerance of the reference's scale)
        runs = [("fwd", lambda: kernels["conv4d_fwd"](x, w, b),
                 lambda: fwd_plain(x, w, b),
                 lambda: fwd_plain(x.float(), w.float(), b), TOL[dtype]),
                ("dw", lambda: kernels["conv4d_dw"](x, gr, KSIZE),
                 lambda: dw_plain(x, gr, KSIZE), lambda: dw_plain(x, gr, KSIZE),
                 DW_TOL[dtype])]
        if (cin, cout) in dx_layers:
            runs.append(("dx", lambda: kernels["conv4d_dx"](gr, w),
                         lambda: dx_plain(gr, w),
                         lambda: dx_plain(gr.float(), w.float()), TOL[dtype]))
        for name, kern, plain, reference, tol in runs:
            ms = time_ms(kern, reps=3)
            plain_ms = time_ms(plain, reps=1)
            # at this batch the dw kernel runs another chunk and reduction
            # plan than at 2 samples, so it is held to its tolerance here too
            got, again = kern(), kern()
            # one thread sums each output in a fixed order, no atomics
            bitwise = bool(torch.equal(got, again))
            del again
            got, want = got.float(), reference().float()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = (bool(torch.isfinite(got).all()) and err <= tol * scale
                  and (bitwise or name == "dx"))
            del got, want
            # dx is a convolution of g (cout channels) into cin channels:
            # the same multiply-adds on the grid as the forward
            bms, by, flops = (dw_bound_ms if name == "dw" else bound_ms)(
                shape, cin, cout, dtype, KSIZE)
            timed[name].append({
                "layer": li, "shape": list(shape), "cin": cin, "cout": cout,
                "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "gflop": flops / 1e9,
                "tflops": flops / ms / 1e9, "max_abs_err": err,
                "max_rel_err": err / scale, "tol_rel": tol,
                "bitwise_repeat": bitwise, "ok": ok})
            torch.cuda.empty_cache()
            if not ok:
                emit({"phase": "train_kernels", "checks": checks, "timed": timed})
                raise AssertionError(
                    f"conv4d {name} kernel disagrees at the training batch: "
                    f"{timed[name][-1]}")
    wide = dw_wide_grid(kernels["conv4d_dw"], dw_plain)
    f32 = dw_f32_timed(kernels["conv4d_dw"], dw_plain)
    timed["dw"] += f32
    edges = dw_edge_shapes(kernels["conv4d_dw"], dw_plain)
    emit({"phase": "train_kernels", "card": smi, "checks": checks,
          "timed": timed, "dw_48x48": wide, "dw_edges": edges})
    if not all(rec["ok"] for rec in f32 + edges):
        raise AssertionError(f"the float32 dw kernel disagrees: {f32 + edges}")
    return timed["fwd"], timed["dx"], timed["dw"]


def dw_f32_timed(conv4d_dw, dw_plain):
    """The float32 dw of every NC layer at 2 samples (the gradient check's
    batch) and at 32 (one `--no-bf16` training pipeline call) on the 25^4
    grid: CUDA-event times beside the plain version (one call between two
    events), the device time of the split, pass 1 and pass 2, the bound
    and the FFMA ceiling; held to DW_TOL of the plain version's scale with
    a bitwise repeat."""
    records = []
    for n in (2, TRAIN_SAMPLES):
        shape = (n, GRID, GRID, GRID, GRID)
        for li, (cin, cout) in enumerate(NC_LAYERS):
            x, _, _ = nc_inputs(shape, cin, cout, torch.float32, seed=140 + li)
            gr = torch.randn(*shape, cout, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(145 + li))

            def kern(x=x, gr=gr):
                return conv4d_dw(x, gr, KSIZE)

            ms = time_ms(kern, reps=3)
            passes = dw_passes_ms(conv4d_dw, kern, reps=3)
            got, again = kern(), kern()
            bitwise = bool(torch.equal(got, again))
            del again
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            want = dw_plain(x, gr, KSIZE)
            stop.record()
            stop.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            bms, by, flops = dw_bound_ms(shape, cin, cout, torch.float32, KSIZE)
            records.append({
                "layer": li, "shape": list(shape), "cin": cin, "cout": cout,
                "dtype": "float32", "path": "train", "ms": ms,
                "plain_ms": start.elapsed_time(stop), "pass_ms": passes,
                "bound_ms": bms, "bound_by": by,
                "ffma_bound_ms": ffma_bound_ms(flops), "gflop": flops / 1e9,
                "tflops": flops / ms / 1e9, "max_abs_err": err,
                "max_rel_err": err / scale, "tol_rel": DW_TOL[torch.float32],
                "bitwise_repeat": bitwise,
                "ok": (bool(torch.isfinite(got).all())
                       and err <= DW_TOL[torch.float32] * scale and bitwise)})
            del x, gr, got, want
            torch.cuda.empty_cache()
    return records


def dw_edge_shapes(conv4d_dw, dw_plain):
    """The float32 dw at `DW_EDGE_SHAPES` against the plain version
    (DW_TOL of its scale) with a bitwise repeat."""
    records = []
    for ci, (shape, ks, cin, cout) in enumerate(DW_EDGE_SHAPES):
        x, _, _ = nc_inputs(shape, cin, cout, torch.float32, seed=150 + ci, ks=ks)
        gr = torch.randn(*shape, cout, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(155 + ci))
        got, again = conv4d_dw(x, gr, ks), conv4d_dw(x, gr, ks)
        want = dw_plain(x, gr, ks)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        bitwise = bool(torch.equal(got, again))
        records.append({
            "shape": list(shape), "ks": ks, "cin": cin, "cout": cout,
            "max_abs_err": err, "max_rel_err": err / scale,
            "tol_rel": DW_TOL[torch.float32], "bitwise_repeat": bitwise,
            "ok": (bool(torch.isfinite(got).all())
                   and err <= DW_TOL[torch.float32] * scale and bitwise)})
    return records


def dw_wide_grid(conv4d_dw, dw_plain):
    """dw on the 48x48 grid of 768 px, where a block stages a window of
    k-rows (a whole-grid staging no longer fits): each layer and dtype at
    1 sample against the plain version (DW_TOL of max |dw|) with a bitwise
    repeat, and the bfloat16 kernel timed at the 4 samples of one 768 px
    pipeline call (2 pairs x 2 directions)."""
    g = WIDE_GRID
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for li, (cin, cout) in enumerate(NC_LAYERS):
            shape = (1, g, g, g, g)
            x, _, _ = nc_inputs(shape, cin, cout, dtype, seed=90 + li)
            gr = torch.randn(*shape, cout, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(95 + li)).to(dtype)
            got, again = conv4d_dw(x, gr, KSIZE), conv4d_dw(x, gr, KSIZE)
            want = dw_plain(x, gr, KSIZE)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            bitwise = bool(torch.equal(got, again))
            ok = (bool(torch.isfinite(got).all()) and err <= DW_TOL[dtype] * scale
                  and bitwise)
            rec = {"layer": li, "cin": cin, "cout": cout, "grid": g,
                   "dtype": str(dtype).split(".")[1], "max_abs_err": err,
                   "max_rel_err": err / scale, "tol_rel": DW_TOL[dtype],
                   "bitwise_repeat": bitwise, "ok": ok}
            if dtype == torch.float32:
                rec["ms_1_sample"] = time_ms(lambda: conv4d_dw(x, gr, KSIZE), reps=3)
            del x, gr, got, again, want
            if dtype == torch.bfloat16:
                shape = (4, g, g, g, g)
                x, _, _ = nc_inputs(shape, cin, cout, dtype, seed=97 + li)
                gr = torch.randn(*shape, cout, device="cuda").to(dtype)
                rec["ms_4_samples"] = time_ms(lambda: conv4d_dw(x, gr, KSIZE), reps=3)
                del x, gr
            records.append(rec)
            torch.cuda.empty_cache()
            if not ok:
                emit({"phase": "train_kernels", "dw_48x48": records})
                raise AssertionError(f"conv4d dw disagrees on the 48x48 grid: {rec}")
    return records


def phase_synthetic_kernels(smi, kernels, fwd_plain, dx_plain, dw_plain):
    """The forward, dx and dw kernels at the synthetic convergence run's
    own shapes (`SYNTH_SHAPE`, 3^4), float32 and bfloat16 as it trains in
    both: each against its plain version on the same inputs (forward and
    dx in float32, TOL; dw, DW_TOL) with a bitwise repeat, timed beside the
    plain version in the kernel's dtype and the bound. Returns ``{"fwd",
    "dx", "dw"}`` lists of records."""
    from ncnet_tpu_torch.kernels.conv4d import flip_transpose

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, ks = SYNTH_SHAPE, SYNTH_KS
    timed = {"fwd": [], "dx": [], "dw": []}
    for dtype in (torch.float32, torch.bfloat16):
        for li, (cin, cout) in enumerate(SYNTH_LAYERS):
            x, w, b = nc_inputs(shape, cin, cout, dtype, seed=120 + li, ks=ks)
            gr = torch.randn(*shape, cout, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(125 + li)).to(dtype)
            # (name, kernel, plain version as timed, reference, tolerance
            # of the reference's scale, bound)
            runs = [("fwd", lambda: kernels["conv4d_fwd"](x, w, b),
                     lambda: fwd_plain(x, w, b),
                     lambda: fwd_plain(x.float(), w.float(), b), TOL[dtype], bound_ms),
                    ("dw", lambda: kernels["conv4d_dw"](x, gr, ks),
                     lambda: dw_plain(x, gr, ks), lambda: dw_plain(x, gr, ks),
                     DW_TOL[dtype], dw_bound_ms)]
            if li > 0:
                runs.append(("dx", lambda: kernels["conv4d_dx"](gr, w),
                             lambda: dx_plain(gr, w),
                             lambda: dx_plain(gr.float(), w.float()), TOL[dtype],
                             bound_ms))
            for name, kern, plain, reference, tol, bound in runs:
                ms = time_ms(kern, reps=5)
                plain_ms = time_ms(plain, reps=5)
                got, again = kern(), kern()
                bitwise = bool(torch.equal(got, again))
                # float32 forward and dx run on the FFMA route (one input or
                # one output channel): the chain oracle's bits exactly
                oracle = None
                if dtype == torch.float32 and name == "fwd":
                    oracle = ffma_oracle_bitwise(kernels["conv4d_fwd"], got, x, w, b)
                elif dtype == torch.float32 and name == "dx":
                    oracle = ffma_oracle_bitwise(kernels["conv4d_fwd"], got, gr,
                                                 flip_transpose(w))
                got, want = got.float(), reference().float()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                ok = (bool(torch.isfinite(got).all()) and err <= tol * scale
                      and bitwise and oracle is not False)
                bms, by, flops = bound(shape, cin, cout, dtype, ks)
                extra = ({"pass_ms": dw_passes_ms(kernels["conv4d_dw"], kern, reps=5),
                          "ffma_bound_ms": ffma_bound_ms(flops)}
                         if name == "dw" else {})
                timed[name].append({**extra,
                    "layer": li, "shape": list(shape), "cin": cin, "cout": cout,
                    "ks": ks, "dtype": str(dtype).split(".")[1], "path": "eval",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "gflop": flops / 1e9,
                    "tflops": flops / ms / 1e9, "max_abs_err": err,
                    "max_rel_err": err / scale, "tol_rel": tol,
                    "bitwise_repeat": bitwise, "oracle_bitwise": oracle,
                    "ok": ok})
                if not ok:
                    emit({"phase": "synthetic_kernels", "timed": timed})
                    raise AssertionError(
                        f"conv4d {name} kernel disagrees at the synthetic run's "
                        f"shape: {timed[name][-1]}")
    emit({"phase": "synthetic_kernels", "card": smi, "timed": timed})
    return timed


def nc_grads(model, config, batch, objective, dtype=None):
    """An objective and its NC gradients for ``batch``; with ``dtype`` the
    correlation and the NC stack run in it.

    ``objective``: ``"score"``, the positive term of the weak loss,
    ``-match_score(corr_pos)`` (the weak loss itself is no test: on a
    random trunk its two terms cancel to about 1e-8 against scores of
    about 1.6e-3, so its gradient is float32 rounding); or a fixed random
    ``[b, 25, 25, 25, 25]`` tensor dotted with the NC stack's output,
    which holds the stack's gradients without the softmax and max."""
    from ncnet_tpu_torch.models.immatchnet import extract_features, match_pipeline
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.train.loss import match_score

    leaves = model.neigh_consensus.trainable()
    for t in leaves:
        t.grad = None
    fa = extract_features(model, config, batch["source_image"])
    fb = extract_features(model, config, batch["target_image"])
    if dtype is not None:
        fa, fb = fa.to(dtype), fb.to(dtype)
    if objective == "score":
        loss = -match_score(match_pipeline(model.neigh_consensus, config, fa, fb))
    else:
        out = model.neigh_consensus(mutual_matching(correlation_4d(fa, fb)))
        r = torch.randn(out.shape, device=out.device, generator=torch.Generator(
            device=out.device).manual_seed(SEED + 5))
        loss = (out * r.to(out.dtype)).sum() / out.numel()
    loss.backward()
    return float(loss.detach()), [t.grad.clone() for t in leaves]


def synthetic_batch(n, seed, hw=SQUARE_HW):
    """``n`` pairs of `SyntheticPairDataset` at ``hw``, on the card."""
    from ncnet_tpu_torch.data.loader import collate
    from ncnet_tpu_torch.data.pairs import SyntheticPairDataset
    from ncnet_tpu_torch.train.step import device_batch

    ds = SyntheticPairDataset(n=n, output_size=hw, seed=seed)
    return device_batch(collate([ds[i] for i in range(n)]), "cuda")


def pair_features(model, config, batch):
    """Both images' trunk features, or a feature batch's own (cast as
    `weak_loss_from_features` casts them: its "trunk" stage is that cast)."""
    from ncnet_tpu_torch.models.immatchnet import extract_features

    if "source_features" in batch:
        dtype = torch.bfloat16 if config.half_precision else batch["source_features"].dtype
        return tuple(batch[k].to(dtype) for k in ("source_features", "target_features"))
    return tuple(extract_features(model, config, batch[k])
                 for k in ("source_image", "target_image"))


def train_stage_breakdown(model, config, batch, optimizer):
    """CUDA-event times of one training step's stages, in order, on one
    batch (images, or cached features: `pair_features`): trunk (both
    images), correlation + MM (both pipelines), NC forward (both
    pipelines), post-NC MM + scores + loss, backward, optimizer; and the
    whole step."""
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.train.loss import match_score_per_sample

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    dtype = torch.bfloat16 if config.half_precision else torch.float32
    optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    ev[0].record()
    fa, fb = pair_features(model, config, batch)
    ev[1].record()
    corrs = [mutual_matching(correlation_4d(a, fb)).to(dtype)
             for a in (fa, torch.roll(fa, -1, 0))]
    ev[2].record()
    filtered = [model.neigh_consensus(c) for c in corrs]
    ev[3].record()
    pos, neg = (match_score_per_sample(mutual_matching(c).float()) for c in filtered)
    loss = neg.mean() - pos.mean()
    ev[4].record()
    loss.backward()
    ev[5].record()
    optimizer.step()
    ev[6].record()
    ev[6].synchronize()
    names = ("trunk", "correlation_mm", "neigh_consensus_forward",
             "mm_score_loss", "backward", "optimizer")
    out = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    out["step"] = ev[0].elapsed_time(ev[6])
    return out


def f32_stage_breakdown(model, config, batch, optimizer):
    """`train_stage_breakdown` of 2 float32 steps (``config`` with
    ``half_precision=False``, as ``train --no-bf16``), the second under
    ``torch.profiler``: its dw launches' device time (split, pass 1, pass
    2; `dw_trace`, which checks that the trace holds every launch: a
    trace short of one is taken again on a further step, up to
    `TRACE_TRIES`) and
    their share of the backward; the peak memory of the profiled step. The
    NC weights and the optimizer's state are restored after, so the
    phases that follow see the model the bfloat16 steps left."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from ncnet_tpu_torch.kernels.conv4d_dw import conv4d_dw

    params = model.neigh_consensus.trainable()
    saved = [t.detach().clone() for t in params]
    saved_opt = copy.deepcopy(optimizer.state_dict())
    steps = [train_stage_breakdown(model, config, batch, optimizer)]
    for _ in range(TRACE_TRIES):
        calls, pass1 = conv4d_dw.launches, conv4d_dw.pass1_launches
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps.append(train_stage_breakdown(model, config, batch, optimizer))
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        calls = conv4d_dw.launches - calls
        dw = dw_trace(prof, calls, conv4d_dw.pass1_launches - pass1)
        if dw["complete"]:
            break
    with torch.no_grad():
        for t, t0 in zip(params, saved):
            t.copy_(t0)
    optimizer.load_state_dict(saved_opt)
    dw_ms = ({k: dw[k] * calls for k in ("split", "pass1", "pass2")}
             if dw["complete"] else None)
    return {"steps": steps, "dw_calls": calls, "dw_trace": dw,
            "dw_device_ms": sum(dw_ms.values()) if dw_ms else None,
            "dw_device_ms_by_pass": dw_ms, "peak_memory_bytes": peak,
            "dw_share_of_backward": (sum(dw_ms.values()) / steps[-1]["backward"]
                                     if dw_ms else None)}


def phase_train(smi, model, config, kernels, conv4d_plain):
    """Gradient check, 3 trainer steps at the PF-Pascal config, the CLI;
    returns the launches of the 3 steps per kernel."""
    import ncnet_tpu_torch.ops.conv4d as ops_conv4d
    from ncnet_tpu_torch.data.loader import DataLoader
    from ncnet_tpu_torch.data.pairs import SyntheticPairDataset
    from ncnet_tpu_torch.kernels.conv4d import flip_transpose
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet
    from ncnet_tpu_torch.train.checkpoint import load_checkpoint, restore
    from ncnet_tpu_torch.train.step import (
        create_train_state,
        device_batch,
        make_train_step,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # (a) NC gradients at full width, 2 pairs, float32 through the kernels
    # against the plain differentiable conv4d (cuDNN conv3d + autograd) in
    # float64; the same plain version in float32 is reported beside it
    f32 = config.replace(half_precision=False)
    batch = synthetic_batch(2, SEED + 3)
    grad_check, dx_oracle = [], []
    for objective in ("linear", "score"):
        # the 16->1 layer's dx (a 1->16 layer on the FFMA route) as the
        # check runs it: held to the chain oracle's bits
        calls = []
        real_dx = ops_conv4d.conv4d_dx

        def recording_dx(g, w, real_dx=real_dx, calls=calls):
            out = real_dx(g, w)
            if g.dtype == torch.float32 and g.shape[-1] == 1:
                calls.append({"objective": objective, "shape": list(g.shape),
                              "oracle_bitwise": ffma_oracle_bitwise(
                                  kernels["conv4d_fwd"], out, g,
                                  flip_transpose(w))})
            return out

        ops_conv4d.conv4d_dx = recording_dx
        try:
            loss_k, grads_k = nc_grads(model, f32, batch, objective)
        finally:
            ops_conv4d.conv4d_dx = real_dx
        dx_oracle += calls
        if not calls or not all(c["oracle_bitwise"] for c in calls):
            emit({"phase": "train", "grad_check_dx_oracle": dx_oracle})
            raise AssertionError(
                f"the gradient check's 16->1 dx is not the chain oracle's: {calls}")
        conv = model.neigh_consensus.conv
        model.neigh_consensus.conv = conv4d_plain
        try:
            loss_p, grads_p = nc_grads(model, f32, batch, objective, torch.float64)
            _, grads_p32 = nc_grads(model, f32, batch, objective)
        finally:
            model.neigh_consensus.conv = conv
        for i, (gk, gp, g32) in enumerate(zip(grads_k, grads_p, grads_p32)):
            # the scale is the layer's (kernel and bias together): the last
            # layer's bias gradient is a sum over every output position
            # that nearly cancels, so its own max is no scale for rounding
            layer = grads_p[i - i % 2:i - i % 2 + 2]
            scale = max(float(t.abs().max()) for t in layer)
            err = float((gk - gp).abs().max())
            err32 = float((g32 - gp).abs().max())
            grad_check.append({
                "objective": objective,
                "tensor": f"layer{i // 2}.{('kernel', 'bias')[i % 2]}",
                "max_abs_err": err, "scale": scale,
                "plain_f32_max_abs_err": err32, "loss": [loss_k, loss_p],
                "ok": (bool(torch.isfinite(gk).all())
                       and err <= max(GRAD_RATIO * err32, GRAD_TOL * scale)
                       and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p))})
    if not all(c["ok"] for c in grad_check):
        emit({"phase": "train", "grad_check": grad_check})
        raise AssertionError(f"NC gradients through the kernels disagree: {grad_check}")
    for t in model.neigh_consensus.trainable():
        t.grad = None

    # (b) 3 trainer steps at the full configuration, bfloat16
    bf16 = config.replace(half_precision=True)
    ds = SyntheticPairDataset(n=TRAIN_BATCH * (TRAIN_STEPS + 1),
                              output_size=SQUARE_HW, seed=SEED + 4)
    loader = DataLoader(ds, TRAIN_BATCH, shuffle=True, seed=SEED, num_workers=4,
                        drop_last=True)
    batches = [device_batch(b, "cuda") for b in loader.iter_epoch(0)]
    trunk0 = {k: v.clone() for k, v in model.feature_extraction.state_dict().items()}
    nc0 = [t.detach().clone() for t in model.neigh_consensus.trainable()]
    state = create_train_state(model, 5e-4)
    step = make_train_step(bf16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for name in kernels:
        kernels[name].launches = 0
    for b in batches[:TRAIN_STEPS]:
        before = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append({n: k.launches - before[n] for n, k in kernels.items()})
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {n: 0 for n in kernels}
    want.update(conv4d_fwd=6, conv4d_dx=4, conv4d_dw=6)
    problems = []
    if any(p != want for p in per_step):
        problems.append(f"launches per step {per_step} != {want}")
    if not all(l.dtype == torch.float32 and l.shape == () and bool(torch.isfinite(l))
               for l in losses):
        problems.append(f"losses not finite float32 scalars: {losses}")
    for t in state.optimizer.param_groups[0]["params"]:
        st = state.optimizer.state[t]
        if not (t.dtype == st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32):
            problems.append("master weights or Adam state not float32")
    moved = [float((t.detach() - t0).abs().max()) for t, t0 in
             zip(state.optimizer.param_groups[0]["params"], nc0)]
    # every NC tensor must move but the last layer's bias: its gradient is
    # one sum over every output position, and on a random trunk the weak
    # loss's positive and negative terms cancel in it below bfloat16's
    # resolution once each is rounded to the bias's dtype (as in the JAX
    # package), so it can be exactly zero
    if not all(m > 0 for m in moved[:-1]):
        problems.append(f"NC tensors other than layer 3's bias did not move: {moved}")
    if not all(torch.equal(v, trunk0[k])
               for k, v in model.feature_extraction.state_dict().items()):
        problems.append("the trunk changed")
    stages = train_stage_breakdown(model, bf16, batches[TRAIN_STEPS], state.optimizer)
    stages_f32 = f32_stage_breakdown(model, f32, batches[TRAIN_STEPS], state.optimizer)
    if problems:
        emit({"phase": "train", "problems": problems})
        raise AssertionError("; ".join(problems))

    # (c) one step at 768 px (48x48 grids), batch 2: dw stages windows
    wide_batch = synthetic_batch(2, SEED + 6, WIDE_HW)
    torch.cuda.synchronize()
    before = {n: k.launches for n, k in kernels.items()}
    t0 = time.perf_counter()
    state, wide_loss = step(state, wide_batch)
    torch.cuda.synchronize()
    wide = {"hw": list(WIDE_HW), "batch": 2, "loss": float(wide_loss),
            "step_ms": (time.perf_counter() - t0) * 1e3,
            "launches": {n: k.launches - before[n] for n, k in kernels.items()}}
    del wide_batch
    torch.cuda.empty_cache()
    if wide["launches"] != want or not bool(torch.isfinite(wide_loss)):
        emit({"phase": "train", "wide_step": wide})
        raise AssertionError(f"the 768 px step failed: {wide}")

    # (d) the CLI in a subprocess; its checkpoint must load
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "ncnet_tpu_torch.train", "--synthetic",
             "--allow_random_fe", "--max-steps", "2", "--result_model_dir", out],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        if proc.returncode != 0:
            raise AssertionError(f"training CLI failed (rc {proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        ck = load_checkpoint(report["checkpoint"])
        cli_model = ImMatchNet(ck.config, device="cuda")
        restore(create_train_state(cli_model), ck)
        restored = all(np.array_equal(t.detach().cpu().numpy(), np.asarray(ref))
                       for p, ref_p in zip(cli_model.neigh_consensus.params(),
                                           ck.params["neigh_consensus"])
                       for t, ref in ((p["kernel"], ref_p["kernel"]),
                                      (p["bias"], ref_p["bias"])))
        cli = {k: report[k] for k in ("steps", "step_losses", "step_ms",
                                      "peak_memory_bytes", "kernel_launches")}
        cli["checkpoint_bytes"] = os.path.getsize(report["checkpoint"])
    cli_want = {n: 0 for n in report["kernel_launches"]}
    cli_want.update(conv4d_fwd=12, conv4d_dx=8, conv4d_dw=12)
    if not (report["steps"] == 2 and ck.step == 2 and restored
            and report["kernel_launches"] == cli_want
            and set(cli_want) == set(kernels)):
        raise AssertionError(f"training CLI report or checkpoint wrong: {cli}")
    emit({"phase": "train", "card": smi, "config": bf16.to_dict(),
          "batch": TRAIN_BATCH, "grad_check": grad_check,
          "grad_check_dx_oracle": dx_oracle, "losses": [float(l) for l in losses],
          "step_ms": step_ms, "launches_per_step": per_step,
          "launches": launches, "nc_param_max_move": moved,
          "peak_memory_bytes": peak, "stages_ms": stages,
          "stages_ms_float32": stages_f32, "wide_step": wide, "cli": cli})
    return launches


def pf_pascal_pairs(n, seed):
    """``n`` generated PF-Pascal samples (`pf_pascal_sample`, 'scnet'
    procedure, 400 px): a smooth random texture of a PF-Pascal image size
    as the source, the source rolled right by a known shift as the target,
    and 6-12 keypoints in the target's right half with their source
    positions, written in the CSV's ``x1;x2;...`` columns."""
    from ncnet_tpu_torch.data.images import resize_bilinear_np
    from ncnet_tpu_torch.data.pairs import pf_pascal_sample

    rng = np.random.RandomState(seed)
    sizes = ((300, 500), (375, 500), (500, 333), (400, 400))
    samples = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        base = rng.rand(h // 8, w // 8, 3).astype(np.float32) * 255.0
        src = resize_bilinear_np(base, h, w)
        shift = rng.randint(0, w // 4)
        tgt = np.roll(src, shift, axis=1)
        m = rng.randint(6, 13)
        xb = rng.uniform(0.55 * w, 0.95 * w, m)
        yb = rng.uniform(0.1 * h, 0.9 * h, m)

        def col(v):
            return ";".join(f"{x:.4f}" for x in v)

        row = [f"src{i}.jpg", f"tgt{i}.jpg", str(1 + i % 20), col(xb - shift),
               col(yb), col(xb), col(yb)]
        samples.append(pf_pascal_sample(src, tgt, row, output_size=SQUARE_HW))
    return samples


def pair_tensors(batch, j):
    """Pair ``j`` of a collated numpy batch as ``[1, h, w, 3]`` CUDA tensors."""
    return tuple(torch.from_numpy(np.asarray(batch[k][j:j + 1], np.float32)).cuda()
                 for k in ("source_image", "target_image"))


def pair_readouts(model, config, batches, conv_attr, plain):
    """Every pair of ``batches`` through the forward with the kernels and
    again with ``plain`` as the NC head's ``conv_attr``: per pair, whether
    the kernel's readout agrees with the plain one up to ties
    (`argmax_agrees`) and whether its picks are identical."""
    from ncnet_tpu_torch.models.immatchnet import immatchnet_apply
    from ncnet_tpu_torch.ops.matches import corr_to_matches

    nc = model.neigh_consensus
    agree, identical = [], []
    for batch in batches:
        for j in range(len(batch["source_image"])):
            src, tgt = pair_tensors(batch, j)
            with torch.inference_mode():
                corr_k = immatchnet_apply(model, config, src, tgt)
                kept = getattr(nc, conv_attr)
                setattr(nc, conv_attr, plain)
                try:
                    corr_p = immatchnet_apply(model, config, src, tgt)
                finally:
                    setattr(nc, conv_attr, kept)
                agree.append(argmax_agrees(corr_k, corr_p))
                same = True
                for invert in (False, True):
                    picks = [torch.stack(corr_to_matches(
                        c, do_softmax=True, scale="positive",
                        invert_matching_direction=invert, return_indices=True)[5:])
                        for c in (corr_k, corr_p)]
                    same &= bool(torch.equal(*picks))
                identical.append(same)
    return agree, identical


def pck_readout_problems(label, results, agree, identical):
    """A pair's readout must agree with the plain one up to ties, and its
    PCK (over ``results``, lists over the same pairs) may differ only
    where a tie went the other way (picks not identical). Returns the
    problems and the pairs whose PCK differs."""
    ref = np.asarray(results[0])
    differ = sorted({int(i) for r in results[1:] for i in
                     np.flatnonzero(np.abs(np.asarray(r) - ref) > 1e-6)})
    problems = [f"{label} pair {i}: the kernel's readout is not the plain one "
                "up to ties" for i, ok in enumerate(agree) if not ok]
    problems += [f"{label} pair {i}: PCK differs ({[r[i] for r in results]}) "
                 "with identical readout picks" for i in differ if identical[i]]
    return problems, differ


def phase_eval(smi, config, kernels, conv4d_plain, band_plain):
    """(a) The synthetic convergence run at its defaults, float32 and
    bfloat16, through the kernels; (b) PF-Pascal PCK at the PF-Pascal config
    on generated keypointed pairs through `evaluate`, `evaluate_serving` and
    `pck_vs_topk` at K = BAND_K: every pair's readout, dense and on the
    band, agrees with the plain kernels' up to ties, and its PCK equals
    theirs unless a tie went the other way. Returns the launches of the
    main path's run."""
    from ncnet_tpu_torch.data.loader import collate
    from ncnet_tpu_torch.eval import pf_pascal, synthetic
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet

    for k in kernels.values():
        k.launches = 0
    convergence = {}
    for name, half in (("float32", False), ("bfloat16", True)):
        before = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        out = synthetic.run(device="cuda", half_precision=half, verbose=False)
        rec = {k: out[k] for k in ("loss_first", "loss_last", "loss_deciles",
                                   "pck_before", "pck_after",
                                   "pck_diagonal_baseline")}
        rec["seconds"] = time.perf_counter() - t0
        rec["launches"] = {n: k.launches - before[n] for n, k in kernels.items()}
        rec["ok"] = (out["loss_last"] < out["loss_first"]
                     and out["pck_after"] >= out["pck_before"] + SYNTH_MARGIN
                     and out["pck_after"] >= out["pck_diagonal_baseline"] + SYNTH_MARGIN
                     and all(rec["launches"][n] > 0 for n in
                             ("conv4d_fwd", "conv4d_dx", "conv4d_dw")))
        convergence[name] = rec
        del out
    if not all(r["ok"] for r in convergence.values()):
        emit({"phase": "eval", "synthetic": convergence})
        raise AssertionError(f"synthetic convergence not shown: {convergence}")

    # centred features (as the synthetic convergence): the random trunk's
    # uncentred features correlate almost uniformly, and the dense readout
    # then matched no keypoint of any pair (with the identity NC init
    # too), which could not show a readout flip
    config = config.replace(center_features=True)
    model = ImMatchNet(config, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    samples = pf_pascal_pairs(PF_PAIRS, SEED + 7)
    batches = [collate(samples[i:i + MAX_BATCH])
               for i in range(0, PF_PAIRS, MAX_BATCH)]
    conv0, band0 = kernels["conv4d_fwd"].launches, kernels["band_gemm_fwd"].launches
    res_k = pf_pascal.evaluate(model, config, batches, verbose=False)
    pf_launches = kernels["conv4d_fwd"].launches - conv0
    t0 = time.perf_counter()  # a second, warm pass: the batch time
    pf_pascal.evaluate(model, config, batches, verbose=False)
    eval_s = time.perf_counter() - t0
    res_s = pf_pascal.evaluate_serving(model, config, batches,
                                       max_batch=MAX_BATCH, verbose=False)
    res_b = pf_pascal.pck_vs_topk(model, config, batches, ks=[BAND_K])[BAND_K]
    band_launches = kernels["band_gemm_fwd"].launches - band0
    launches = {n: k.launches for n, k in kernels.items()}

    # the same evals with the plain versions of the kernels
    nc = model.neigh_consensus
    conv, layer = nc.conv, nc.band_layer
    nc.conv, nc.band_layer = conv4d_plain, band_plain
    try:
        res_p = pf_pascal.evaluate(model, config, batches, verbose=False)
        res_bp = pf_pascal.pck_vs_topk(model, config, batches, ks=[BAND_K])[BAND_K]
    finally:
        nc.conv, nc.band_layer = conv, layer
    agree, identical = pair_readouts(model, config, batches, "conv", conv4d_plain)
    problems, differ = pck_readout_problems(
        "dense", [res_p["per_pair"], res_k["per_pair"], res_s["per_pair"]],
        agree, identical)
    band_agree, band_identical = pair_readouts(
        model, config.replace(nc_topk=BAND_K), batches, "band_layer", band_plain)
    band_problems, band_differ = pck_readout_problems(
        f"K = {BAND_K}", [res_bp["per_pair"], res_b["per_pair"]],
        band_agree, band_identical)
    problems += band_problems
    n_batches = len(batches)
    if pf_launches != 3 * n_batches:
        problems.append(f"evaluate launched conv4d {pf_launches} times, not "
                        f"3 x {n_batches} square batches")
    if band_launches != 6 * n_batches:
        problems.append(f"pck_vs_topk launched the band kernel {band_launches} "
                        f"times, not 6 x {n_batches} batches")
    if res_s["serve"]["completed"] != PF_PAIRS or res_s["serve"]["failed"]:
        problems.append(f"evaluate_serving: {res_s['serve']}")
    if not (res_k["n_valid"] == res_p["n_valid"] == PF_PAIRS
            and all(np.isfinite(res_k["per_pair"]))):
        problems.append("PCK not valid for every pair")
    record = {"phase": "eval", "card": smi, "synthetic": convergence,
              "synthetic_margin": SYNTH_MARGIN,
              "pf_pascal": {
                  "config": config.to_dict(), "pairs": PF_PAIRS,
                  "batch": MAX_BATCH, "pck": res_k["pck"],
                  "per_pair": res_k["per_pair"],
                  "per_pair_plain": res_p["per_pair"],
                  "per_pair_served": res_s["per_pair"],
                  "readout_agrees": agree, "readout_identical": identical,
                  "pck_differing_pairs": differ,
                  "warm_eval_s": eval_s,
                  "ms_per_batch": 1e3 * eval_s / n_batches,
                  "serve": {k: res_s["serve"][k] for k in (
                      "batches", "mean_occupancy", "pairs_per_s",
                      "latency_p50_ms", "latency_p95_ms")},
                  "conv4d_launches": pf_launches},
              "pck_vs_topk": {"k": BAND_K, "pck": res_b["pck"],
                              "per_pair": res_b["per_pair"],
                              "per_pair_plain": res_bp["per_pair"],
                              "readout_agrees": band_agree,
                              "readout_identical": band_identical,
                              "pck_differing_pairs": band_differ,
                              "band_launches": band_launches},
              "launches": launches}
    emit(record)
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def texture(rng, hw, cell):
    """A smooth random uint8 RGB image of size ``hw``: noise on a grid of
    ``cell``-pixel cells, bilinearly upsampled."""
    from ncnet_tpu_torch.data.images import resize_bilinear_np, to_uint8_image

    h, w = hw
    base = rng.rand(h // cell, w // cell, 3).astype(np.float32) * 255.0
    return to_uint8_image(resize_bilinear_np(base, h, w))


def write_shortlist(path, queries):
    """An InLoc shortlist ``.mat`` (``ImgList[0, q]``: the query's file at
    field 0, its panos at field 1) for ``[(query, [panos])]``."""
    from scipy.io import savemat

    dt = np.dtype([("queryname", object), ("topN", object)])
    entries = np.zeros((1, len(queries)), dt)
    for q, (qname, panos) in enumerate(queries):
        entries[0, q] = (np.array([qname], object),
                         np.array([[p] for p in panos], object))
    savemat(path, {"ImgList": entries})


def inloc_readout_check(corr_k, corr_p):
    """The readout picks of the pooled ``corr_k`` (both directions) on the
    plain forward's ``corr_p``: returns the share of picks that differ
    from the plain ones and the largest shortfall of a pick below the
    plain best, relative to the plain scale. Where the two correlations
    differ by at most e, a pick can fall short by at most 2e: a larger
    shortfall is a readout fault, not a tie."""
    b, fs1, fs2, fs3, fs4 = corr_p.shape
    flat_k = corr_k.reshape(b, fs1 * fs2, fs3 * fs4)
    flat_p = corr_p.reshape(b, fs1 * fs2, fs3 * fs4)
    scale = float(corr_p.abs().max())
    differ, worst = 0, 0.0
    for dim in (1, 2):
        idx_k = flat_k.argmax(dim=dim, keepdim=True)
        idx_p = flat_p.argmax(dim=dim, keepdim=True)
        picked = torch.gather(flat_p, dim, idx_k)
        best = torch.gather(flat_p, dim, idx_p)
        differ += int((idx_k != idx_p).sum())
        worst = max(worst, float((best - picked).max()) / scale)
    return differ / (fs1 * fs2 + fs3 * fs4), worst


def phase_inloc(smi, kernels, conv4d_plain):
    """One generated query (4032x3024) against two generated panos
    (1600x1200) through `dump_matches` at the reference's InLoc settings;
    the .mat's contract; one pair's readout against the plain forward;
    the pair's stage times and each conv4d layer at the pooled grid
    against its plain version and bound. Returns ``(launches, layers)``."""
    from scipy.io import loadmat

    from ncnet_tpu_torch.data.images import resize_bilinear_np, to_uint8_image
    from ncnet_tpu_torch.eval import inloc
    from ncnet_tpu_torch.models.immatchnet import (
        ImMatchNet,
        ImMatchNetConfig,
        extract_features,
        immatchnet_apply,
    )
    from ncnet_tpu_torch.ops.correlation import correlation_maxpool4d
    from ncnet_tpu_torch.ops.matches import corr_to_matches
    from ncnet_tpu_torch.ops.matching import mutual_matching

    config = ImMatchNetConfig(
        feature_extraction_cnn="resnet101", ncons_kernel_sizes=(3, 3),
        ncons_channels=(16, 1), half_precision=True,
        relocalization_k_size=INLOC_K,
    )
    model = ImMatchNet(config, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED + 8)
    query = texture(rng, QUERY_HW, 24)
    # pano 0 sees a part of the query's scene, pano 1 another scene
    qh, qw = QUERY_HW
    panos = [to_uint8_image(resize_bilinear_np(
                 query[int(0.3 * qh):int(0.67 * qh), int(0.17 * qw):int(0.83 * qw)],
                 *PANO_HW)),
             texture(rng, PANO_HW, 8)]
    n_slots = inloc.n_match_slots(INLOC_SIZE, INLOC_K, True)
    with tempfile.TemporaryDirectory() as root:
        np.save(os.path.join(root, "query.npy"), query)
        names = []
        for i, pano in enumerate(panos):
            names.append(f"pano{i}.npy")
            np.save(os.path.join(root, names[-1]), pano)
        shortlist = os.path.join(root, "shortlist.mat")
        write_shortlist(shortlist, [("query.npy", names)])
        out_dir = os.path.join(root, "matches")
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = inloc.dump_matches(
            model, config, shortlist, root, root, out_dir,
            image_size=INLOC_SIZE, n_queries=1, n_panos=len(panos),
            verbose=False, read_image=lambda p: np.load(p).astype(np.float32))
        dump_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        mat = loadmat(os.path.join(out_dir, "1.mat"))
        # the same dump through the device route (uint8 images, the panos'
        # upscale and every normalize on the card)
        dev_dir = os.path.join(root, "matches_device")
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inloc.dump_matches(
            model, config, shortlist, root, root, dev_dir,
            image_size=INLOC_SIZE, n_queries=1, n_panos=len(panos),
            verbose=False, device_preprocess=True, device_resize=True,
            read_image=lambda p: np.load(p).astype(np.float32))
        dev_dump_s = time.perf_counter() - t0
        dev_launches = {n: k.launches for n, k in kernels.items()}
        dev_mat = loadmat(os.path.join(dev_dir, "1.mat"))
        store_runs = inloc_store_dumps(model, config, root, shortlist, len(panos),
                                       kernels)
        routes = inloc_routes(model, config, root, inloc)
    m = mat["matches"]
    filled = [int((np.abs(m[0, p]).sum(axis=1) > 0).sum()) for p in range(len(panos))]
    problems = []
    if m.shape != (1, len(panos), INLOC_SLOTS, 5) or n_slots != INLOC_SLOTS:
        problems.append(f".mat matches {m.shape}, want (1, 2, {INLOC_SLOTS}, 5)")
    if not (np.isfinite(m).all() and (m[..., :4] >= 0).all() and (m[..., :4] <= 1).all()):
        problems.append("non-finite or out-of-range matches")
    if not all(0 < f <= n_slots for f in filled):
        problems.append(f"filled slots {filled}")
    # a rectangular pair runs the NC net twice: 2 layers x 2 directions
    if launches["conv4d_fwd"] != 4 * len(panos) or done["pairs"] != len(panos):
        problems.append(f"conv4d launches {launches['conv4d_fwd']} != 4 x "
                        f"{len(panos)} pairs")
    if dev_launches != launches:
        problems.append(f"device route launches {dev_launches} != {launches}")
    route_check = mat_route_check(m, dev_mat["matches"])
    for run, trunk_want in zip(store_runs, (1 + len(panos), 1)):
        store_mat = run.pop("mat")
        run["vs_image_route"] = mat_route_check(m, store_mat)
        run["identical_to_image_route"] = bool(np.array_equal(store_mat, m))
        if (run["launches"] != launches or run["trunk_calls"] != trunk_want
                or not run["vs_image_route"]["ok"]):
            problems.append(f"the {run['label']} store dump fails: {run}")

    # one pair: readout against the plain forward, and its stage times
    t0 = time.perf_counter()
    src = inloc.preprocess_image(query, INLOC_SIZE, INLOC_K)
    t1 = time.perf_counter()
    tgt = inloc.preprocess_image(panos[0], INLOC_SIZE, INLOC_K)
    prep_ms = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1))
    src, tgt = torch.from_numpy(src).cuda(), torch.from_numpy(tgt).cuda()
    nc = model.neigh_consensus

    def plain_bf16(x, w, b=None):
        return conv4d_plain(x.float(), w.float(), b).to(x.dtype)

    with torch.inference_mode():
        corr_k, delta_k = immatchnet_apply(model, config, src, tgt)
        conv = nc.conv
        nc.conv = plain_bf16
        try:
            corr_p, delta_p = immatchnet_apply(model, config, src, tgt)
        finally:
            nc.conv = conv
        differ_share, shortfall = inloc_readout_check(corr_k, corr_p)
        corr_err = float((corr_k - corr_p).abs().max() / corr_p.abs().max())
        kw = dict(scale="positive", do_softmax=True, k_size=INLOC_K)
        score_err = 0.0
        for invert in (False, True):
            s_k = corr_to_matches(corr_k, delta4d=delta_k,
                                  invert_matching_direction=invert, **kw)[4]
            s_p = corr_to_matches(corr_p, delta4d=delta_p,
                                  invert_matching_direction=invert, **kw)[4]
            score_err = max(score_err, float((s_k - s_p).abs().max() / s_p.abs().max()))
        deltas_equal = all(torch.equal(a, b) for a, b in zip(delta_k, delta_p))
    readout = {"pooled_grid": list(corr_k.shape), "corr_max_rel_err": corr_err,
               "picks_differing": differ_share, "max_shortfall_rel": shortfall,
               "score_max_rel_err": score_err, "deltas_equal": deltas_equal,
               "tol_rel": INLOC_TOL}
    if not (deltas_equal and corr_err <= INLOC_TOL
            and shortfall <= 2 * corr_err + 1e-6 and score_err <= INLOC_TOL
            and bool(torch.isfinite(corr_k).all())):
        problems.append(f"readout disagrees with the plain forward: {readout}")
    del corr_p, delta_p
    # the device route's pair against the host route's, by the same tie
    # gate: its picks on the host route's correlation short of the best by
    # no more than the two correlations differ (the uint8 rounding of the
    # resized pixels moves the correlation; it is reported, not bounded)
    with torch.inference_mode():
        dsrc = inloc.device_normalize(torch.from_numpy(to_uint8_image(
            resize_bilinear_np(query, *src.shape[1:3]))[None]).cuda())
        u8 = torch.from_numpy(panos[0][None]).cuda()
        dtgt = inloc.device_normalize(inloc.device_resize_uint8(u8, *tgt.shape[1:3]))
        corr_d, delta_d = immatchnet_apply(model, config, dsrc, dtgt)
        differ_d, shortfall_d = inloc_readout_check(corr_d, corr_k)
        corr_err_d = float((corr_d - corr_k).abs().max() / corr_k.abs().max())
    route_check.update(pair_corr_max_rel_err=corr_err_d, pair_picks_differing=differ_d,
                       pair_max_shortfall_rel=shortfall_d)
    route_check["ok"] = bool(route_check["ok"] and shortfall_d <= 2 * corr_err_d + 1e-6
                             and bool(torch.isfinite(corr_d).all()))
    if not route_check["ok"]:
        problems.append(f"the device route fails the gate: {route_check}")
    del corr_d, delta_d, dsrc, dtgt

    match_fn = inloc.make_match_fn(config, concat_directions=True)
    kw = dict(scale="positive", do_softmax=True, delta4d=delta_k, k_size=INLOC_K)
    with torch.inference_mode():
        fa = extract_features(model, config, src)
        fb = extract_features(model, config, tgt)
        pooled, _ = correlation_maxpool4d(fa, fb, INLOC_K)
        mm = mutual_matching(pooled)
        filtered = nc(mm)

        def post_nc_readout():
            c = mutual_matching(filtered).float()
            return torch.cat([torch.stack(corr_to_matches(c, **kw)),
                              torch.stack(corr_to_matches(
                                  c, invert_matching_direction=True, **kw))], 2)

        out = post_nc_readout()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = inloc.match_pair(None, None, None, None, INLOC_K, precomputed=out,
                                shapes=(src.shape, tgt.shape))
        host_ms = 1e3 * (time.perf_counter() - t0)
        stages = {
            "host_resize_normalize_query": prep_ms[0],
            "host_resize_normalize_pano": prep_ms[1],
            "trunk_query": time_ms(lambda: extract_features(model, config, src), 2),
            "trunk_pano": time_ms(lambda: extract_features(model, config, tgt), 2),
            "correlation_maxpool": time_ms(
                lambda: correlation_maxpool4d(fa, fb, INLOC_K), 2),
            "mutual_matching_pre": time_ms(lambda: mutual_matching(pooled), 2),
            "neigh_consensus": time_ms(lambda: nc(mm), 2),
            "mm_post_readout": time_ms(post_nc_readout, 2),
            "host_copy_sort_dedup_recenter": host_ms,
            "matches_after_dedup": len(rows[0]),
            "forward_and_readout": time_ms(lambda: match_fn(model, src, tgt), 2),
            "dump_ms_per_pair": 1e3 * dump_s / len(panos),
            "dump_ms_per_pair_device_route": 1e3 * dev_dump_s / len(panos),
            "routes": routes,
        }
        del fa, fb, pooled, mm, filtered, out
    torch.cuda.empty_cache()
    layers = inloc_layers(kernels["conv4d_fwd"], conv4d_plain, tuple(corr_k.shape[1:]))
    emit({"phase": "inloc", "card": smi, "config": config.to_dict(),
          "query_hw": list(QUERY_HW), "pano_hw": list(PANO_HW),
          "image_size": INLOC_SIZE, "k_size": INLOC_K,
          "src_shape": list(src.shape), "tgt_shape": list(tgt.shape),
          "mat_shape": list(m.shape), "filled_slots": filled,
          "written": done["written"], "launches": launches,
          "device_route_launches": dev_launches, "device_route_mat": route_check,
          "readout": readout, "stages_ms": stages, "layers": layers})
    emit({"phase": "inloc_store", "card": smi, "config": config.to_dict(),
          "image_size": INLOC_SIZE, "pairs_a_dump": len(panos),
          "image_route_s_per_pair": dump_s / len(panos), "dumps": store_runs})
    if problems:
        raise AssertionError("; ".join(problems))
    return {"host": launches, "device": dev_launches,
            "store": {n: sum(r["launches"][n] for r in store_runs)
                      for n in launches}}, layers


def inloc_store_dumps(model, config, root, shortlist, n_panos, kernels):
    """The InLoc dump of ``root``'s query and panos through a gallery
    feature store (``feature_store_dir``), cold then warm: each dump's
    seconds a pair, trunk calls (cold: the query and every pano; warm: the
    query), panos extracted, launches (counts set to 0 just before) and
    ``.mat`` matches."""
    from scipy.io import loadmat

    from ncnet_tpu_torch.eval import inloc

    store_dir = os.path.join(root, "gallery")
    calls = []
    hook = model.feature_extraction.register_forward_hook(lambda *a: calls.append(1))
    runs = []
    try:
        for label in ("cold", "warm"):
            out = os.path.join(root, f"matches_store_{label}")
            for k in kernels.values():
                k.launches = 0
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = inloc.dump_matches(
                model, config, shortlist, root, root, out, image_size=INLOC_SIZE,
                n_queries=1, n_panos=n_panos, verbose=False,
                feature_store_dir=store_dir,
                read_image=lambda p: np.load(p).astype(np.float32))
            secs = time.perf_counter() - t0
            runs.append({"label": label, "s_per_pair": secs / n_panos,
                         "trunk_calls": len(calls),
                         "panos_extracted": done["panos_extracted"],
                         "launches": {n: k.launches for n, k in kernels.items()},
                         "mat": loadmat(os.path.join(out, "1.mat"))["matches"]})
    finally:
        hook.remove()
    runs[0]["store_mbytes"] = store_megabytes(store_dir)
    return runs


def mat_route_check(host, device):
    """The device route's ``.mat`` against the host route's: the contract
    (shape, finite coordinates in [0, 1]) and the scores of the match rows
    both routes hold (the same four coordinates) within INLOC_TOL of the
    host route's largest; the share of the host route's rows the device
    route holds too is reported (a near-tied pick may go either way)."""
    out = {"shape": list(device.shape), "panos": []}
    ok = (device.shape == host.shape and bool(np.isfinite(device).all())
          and bool((device[..., :4] >= 0).all() and (device[..., :4] <= 1).all()))
    for p in range(host.shape[1]):
        h, d = host[0, p], device[0, p]
        h = h[np.abs(h).sum(axis=1) > 0]
        d = d[np.abs(d).sum(axis=1) > 0]
        hk = {tuple(r[:4]): r[4] for r in h}
        dk = {tuple(r[:4]): r[4] for r in d}
        common = hk.keys() & dk.keys()
        share = len(common) / max(len(hk), 1)
        scale = float(np.abs(h[:, 4]).max()) if len(h) else 1.0
        score_err = (max(abs(hk[c] - dk[c]) for c in common) / scale
                     if common else float("inf"))
        out["panos"].append({"rows_host": len(hk), "rows_device": len(dk),
                             "shared_share": share, "score_max_rel_err": score_err})
        ok &= score_err <= INLOC_TOL
    out.update(ok=bool(ok), tol_rel=INLOC_TOL)
    return out


def inloc_routes(model, config, root, inloc):
    """Per image (the query, which the quantized resize shrinks, and pano
    0, which it enlarges), each route's host time (read, resize where the
    host does it, normalize or uint8), transfer time (the host array to
    the card) and device time (the device route's resize and normalize,
    then both routes' forward and readout of the pair)."""
    out = {}
    shapes = {}
    for route, kw in (("host", {}),
                      ("device", dict(device_normalize=True, device_resize=True))):
        fn = inloc.make_match_fn(config, device_preprocess=route == "device",
                                 concat_directions=True)
        rec, on_card = {}, {}
        for name in ("query", "pano0"):
            path = os.path.join(root, f"{name}.npy")
            t0 = time.perf_counter()
            arr = inloc.load_and_preprocess(path, INLOC_SIZE, INLOC_K, read_image=lambda
                                            p: np.load(p).astype(np.float32), **kw)
            host = 1e3 * (time.perf_counter() - t0)
            arr, hw = arr if route == "device" else (arr, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = torch.from_numpy(arr).cuda()
            torch.cuda.synchronize()
            transfer = 1e3 * (time.perf_counter() - t0)
            resize = (time_ms(lambda: inloc.device_resize_uint8(t, *hw), reps=3)
                      if hw is not None else 0.0)
            on_card[name] = t if hw is None else inloc.device_resize_uint8(t, *hw)
            rec[name] = {"host_ms": host, "transfer_ms": transfer,
                         "transfer_mbytes": arr.nbytes / 1e6,
                         "device_resize_ms": resize, "shipped": list(arr.shape),
                         "resized_on_card_to": list(hw) if hw else None}
        with torch.inference_mode():
            rec["pair_forward_readout_ms"] = time_ms(
                lambda: fn(model, on_card["query"], on_card["pano0"]), reps=2)
        shapes[route] = [list(v.shape) for v in on_card.values()]
        rec["host_ms"] = sum(rec[n]["host_ms"] for n in ("query", "pano0"))
        rec["transfer_ms"] = sum(rec[n]["transfer_ms"] for n in ("query", "pano0"))
        rec["device_ms"] = (sum(rec[n]["device_resize_ms"] for n in ("query", "pano0"))
                            + rec["pair_forward_readout_ms"])
        out[route] = rec
    if shapes["host"] != shapes["device"]:
        raise AssertionError(f"the routes feed different shapes: {shapes}")
    return out


def inloc_layers(conv4d_fwd, conv4d_plain, grid):
    """Each NC layer of the InLoc config, bfloat16, at the pooled grid and
    its transpose (a rectangular pair runs the net once in each
    direction): the kernel against its plain version in float32 on the
    same inputs (TOL), a bitwise repeat, and its time beside the plain
    version's in bfloat16 and the bound."""
    fs1, fs2, fs3, fs4 = grid
    dtype, ks = torch.bfloat16, 3
    records = []
    for shape in ((1, fs1, fs2, fs3, fs4), (1, fs3, fs4, fs1, fs2)):
        for li, (cin, cout) in enumerate(INLOC_LAYERS):
            g = torch.Generator(device="cuda").manual_seed(110 + li)
            bound = (cin * ks**4) ** -0.5
            x = torch.rand(*shape, cin, generator=g, device="cuda").to(dtype)
            w = ((torch.rand(ks, ks, ks, ks, cin, cout, generator=g, device="cuda")
                  * 2 - 1) * bound).to(dtype)
            b = (torch.rand(cout, generator=g, device="cuda") * 2 - 1) * bound
            ms = time_ms(lambda: conv4d_fwd(x, w, b), reps=3)
            plain_ms = time_ms(lambda: conv4d_plain(x, w, b), reps=1)
            got, again = conv4d_fwd(x, w, b), conv4d_fwd(x, w, b)
            bitwise = bool(torch.equal(got, again))
            del again
            want = conv4d_plain(x.float(), w.float(), b)
            err = float((got.float() - want).abs().max())
            scale = float(want.abs().max())
            finite = bool(torch.isfinite(got).all())
            del got, want, x
            torch.cuda.empty_cache()
            bms, by, flops = bound_ms(shape, cin, cout, dtype, ks)
            rec = {"layer": li, "shape": list(shape), "cin": cin, "cout": cout,
                   "ks": ks, "dtype": "bfloat16", "path": "inloc", "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
                   "max_abs_err": err, "max_rel_err": err / scale,
                   "tol_rel": TOL[dtype], "bitwise_repeat": bitwise}
            records.append(rec)
            if not (finite and bitwise and err <= TOL[dtype] * scale):
                emit({"phase": "inloc", "layers": records})
                raise AssertionError(f"conv4d kernel disagrees at the InLoc grid: {rec}")
    return records


def sample_geometries(geom):
    """One `BandGeometry` a sample of ``geom`` (the symmetric pass's B-major
    order is per sample), for the plain versions: their per-sample pointer
    tables and gathers stay near 1 GB at the training batch."""
    from ncnet_tpu_torch.ops.band import BandGeometry

    order = ((lambda i: (geom.perm[i:i + 1], geom.inv[i:i + 1]))
             if geom.swapped else (lambda i: ()))
    return [BandGeometry(geom.indices[i:i + 1], geom.grid_b, *order(i))
            for i in range(geom.indices.shape[0])]


def training_band(model, config, seed):
    """The K = 50 mutual band of one training batch's positive pipeline
    (TRAIN_BATCH synthetic pairs at 400 px through the trunk, in the
    training step's bfloat16), as `make_train_step` builds it: the band
    whose hits the band training step's kernels walk. Returns its
    indices and the B grid."""
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.ops.band import topk_band
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching

    cfg = config.replace(half_precision=True, nc_topk=TRAIN_K)
    batch = synthetic_batch(TRAIN_BATCH, seed, SQUARE_HW)
    with torch.no_grad():
        fa = extract_features(model, cfg, batch["source_image"])
        fb = extract_features(model, cfg, batch["target_image"])
        corr = correlation_4d(fa, fb)
        _, idx = topk_band(corr, TRAIN_K, values_from=mutual_matching(corr),
                           mutual=True)
    return idx, (fb.shape[1], fb.shape[2])


def phase_band_train_kernels(smi, model, config, kernels):
    """The band layer's kernels at band training's shapes: the K = 50
    mutual band of one training batch (`training_band`: 16 pairs on 25x25
    grids, 16 x 31,250 entries), both passes, the three PF-Pascal layers,
    bfloat16. The forward, dx (layers 2 and 3:
    layer 1's input is the band, which needs no gradient) and dw against
    their plain versions (per sample, float32 sums of the same bfloat16
    inputs), each called twice on the same inputs (bitwise equal), timed
    by CUDA events beside the plain version in bfloat16 and the bound.
    dw's hit list is built once per pass and shared by the three layers;
    its build is timed and shared out among them. Returns ``{"fwd", "dx",
    "dw"}`` lists of records."""
    from ncnet_tpu_torch.ops.band import (
        band_dw_plain,
        band_dx_plain,
        band_layer_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    fwd, dx, dw = kernels["band_gemm_fwd"], kernels["band_gemm_dx"], kernels["band_gemm_dw"]
    dtype = torch.bfloat16
    idx, grid_b = training_band(model, config, SEED + 12)
    timed = {"fwd": [], "dx": [], "dw": []}
    hit_lists = []
    for name, geom in band_geometries(idx, grid_b).items():
        subs = sample_geometries(geom)
        kernel = (KSIZE,) * 4
        hits = geom.hits(kernel)
        again = dw.hit_list(geom.indices, geom.grid_b, kernel, geom.inv)
        hits_bitwise = all(torch.equal(getattr(hits, f), getattr(again, f))
                           for f in ("tap_start", "n", "m", "block_start"))
        del again
        hit_ms = time_ms(lambda: dw.hit_list(geom.indices, geom.grid_b, kernel,
                                             geom.inv), reps=3)
        # its least time: the bytes it writes (8 a hit and the int64
        # offsets of every (tap, block) run) and reads (indices, inv)
        hit_bytes = (8 * hits.count + 8 * hits.block_start.numel()
                     + 4 * geom.indices.numel() * (2 if geom.swapped else 1))
        hit_lists.append({"pass": name, "hits": hits.count,
                          "hits_per_entry": hits.count / hits.rows,
                          "mbytes": 8 * hits.count / 1e6,
                          "offsets_mbytes": 8 * hits.block_start.numel() / 1e6,
                          "ms": hit_ms, "bound_ms": 1e3 * hit_bytes / PEAK_BYTES,
                          "bound_by": "bytes", "bitwise_repeat": hits_bitwise})
        if not hits_bitwise:
            emit({"phase": "band_train_kernels", "hit_lists": hit_lists})
            raise AssertionError(f"the hit list does not repeat: {hit_lists[-1]}")

        def per_sample(fn, *tensors):
            return torch.cat([fn(*(t[i:i + 1] for t in tensors), g)
                              for i, g in enumerate(subs)])

        for li, (cin, cout) in enumerate(NC_LAYERS):
            n = geom.indices[0].numel()
            x, w, bias = band_layer_inputs(TRAIN_BATCH, n, cin, cout, dtype,
                                           seed=150 + li)
            gen = torch.Generator(device="cuda").manual_seed(160 + li)
            gp = torch.randn(TRAIN_BATCH, n, cout, generator=gen, device="cuda")
            gp = (gp * (torch.rand(gp.shape, generator=gen, device="cuda") > 0.5)).to(dtype)

            def plain_dw(xx, gg):
                out = band_dw_plain(xx[0:1], gg[0:1], subs[0], kernel)
                for i in range(1, len(subs)):
                    out += band_dw_plain(xx[i:i + 1], gg[i:i + 1], subs[i], kernel)
                return out

            # (name, kernel, plain as timed, float32 reference, share of
            # the hit list's build)
            runs = [("fwd", lambda: band_kernel_call(fwd, x, w, bias, geom),
                     lambda: per_sample(lambda xx, g: band_layer_plain(xx, w, bias, g), x),
                     lambda: per_sample(lambda xx, g: band_layer_plain(
                         xx.float(), w.float(), bias.to(dtype).float(), g), x), 0.0),
                    ("dw", lambda: dw(x, gp, hits), lambda: plain_dw(x, gp),
                     lambda: plain_dw(x, gp), hit_ms / len(NC_LAYERS))]
            if li > 0:
                runs.append(("dx", lambda: dx(gp, w, hits),
                             lambda: per_sample(lambda gg, g: band_dx_plain(gg, w, g), gp),
                             lambda: per_sample(lambda gg, g: band_dx_plain(
                                 gg.float(), w.float(), g), gp), 0.0))
            for kname, kern, plain, reference, share in runs:
                ms = time_ms(kern, reps=5)
                plain_ms = time_ms(plain, reps=1)
                got, again = kern(), kern()
                bitwise = bool(torch.equal(got, again))
                got, want = got.float(), reference().float()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                tol = BAND_TOL[dtype] if kname == "fwd" else BAND_GRAD_TOL
                ok = (bool(torch.isfinite(got).all()) and err <= tol * scale
                      and bitwise)
                bound = band_bound_ms(geom, cin, cout, dtype)
                timed[kname].append({
                    "layer": li, "pass": name, "shape": [TRAIN_BATCH, n],
                    "cin": cin, "cout": cout, "k": TRAIN_K, "dtype": "bfloat16",
                    "path": "train_band", "ms": ms + share, "launch_ms": ms,
                    "hit_list_share_ms": share, "plain_ms": plain_ms,
                    "max_abs_err": err, "max_rel_err": err / scale,
                    "tol_rel": tol, "bitwise_repeat": bitwise, "ok": ok, **bound})
                del got, again, want
                if not ok:
                    emit({"phase": "band_train_kernels", "timed": timed,
                          "hit_lists": hit_lists})
                    raise AssertionError(
                        f"band {kname} kernel disagrees at the training shape: "
                        f"{timed[kname][-1]}")
        del subs, hits
        torch.cuda.empty_cache()
    walk = band_walk(kernels)
    emit({"phase": "band_train_kernels", "card": smi, "timed": timed,
          "hit_lists": hit_lists, "walk": walk})
    return timed


def band_walk(kernels):
    """dx and dw of the 16 -> 16 layer, bfloat16, on the plain pass of
    mutual bands of random features (16 samples on 25x25 grids) at K = 16
    and K = 50: as many (input cell, tap) pairs as the training band, with
    fewer hits (the K = 16 list fits in L2). Where dx's time follows the
    pairs and not the hits, its walk over the runs bounds it."""
    dx, dw = kernels["band_gemm_dx"], kernels["band_gemm_dw"]
    out = {}
    for k in (16, 50):
        _, idx = real_band(TRAIN_BATCH, (GRID, GRID), (GRID, GRID), k, SEED + 13)
        geom = band_geometries(idx, (GRID, GRID))["plain"]
        hits = geom.hits((KSIZE,) * 4)
        n = idx[0].numel()
        x, w, _ = band_layer_inputs(TRAIN_BATCH, n, 16, 16, torch.bfloat16, seed=170)
        gp = torch.randn(TRAIN_BATCH, n, 16, device="cuda").to(torch.bfloat16)
        out[f"k{k}"] = {"hits": hits.count, "list_mbytes": 8 * hits.count / 1e6,
                        "cell_tap_pairs": TRAIN_BATCH * GRID**2 * KSIZE**4,
                        "dx_ms": time_ms(lambda: dx(gp, w, hits), reps=10),
                        "dw_ms": time_ms(lambda: dw(x, gp, hits), reps=10)}
        del hits
    return out


class TimedCalls:
    """Stands in for a kernel wrapper and records a pair of CUDA events
    around each of its calls, and apart around its hit-list builds (whose
    hits it counts), so a stage's time can be split by kernel: the
    stream runs them in order."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.events, self.hit_events, self.hits = [], [], []

    @staticmethod
    def _timed(events, fn, *args):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn(*args)
        stop.record()
        events.append((start, stop))
        return out

    def __call__(self, *args):
        return self._timed(self.events, self.kernel, *args)

    def hit_list(self, *args):
        hits = self._timed(self.hit_events, self.kernel.hit_list, *args)
        self.hits.append(hits.count / hits.rows)
        return hits

    @staticmethod
    def ms(events):
        return sum(a.elapsed_time(b) for a, b in events)


def band_train_stage_breakdown(model, config, batch, optimizer):
    """CUDA-event times of one band training step's stages, in order, on
    one batch (images, or cached features: `pair_features`): trunk (both
    images), correlation + MM + top-K (both pipelines), band NC forward
    (both), band MM + scores + loss, backward (split into the dx kernel's
    calls, dw's hit-list builds, whose hits an entry it reports, dw's
    launches, and the rest), Adam; and the whole step."""
    from ncnet_tpu_torch.ops import band
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.sparse import (
        band_mutual_matching,
        resolve_band_width,
        sparse_neigh_consensus_apply,
    )
    from ncnet_tpu_torch.sparse.score import band_match_score_per_sample

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    optimizer.zero_grad(set_to_none=True)
    params = model.neigh_consensus.params()
    dx, dw = TimedCalls(band.band_gemm_dx), TimedCalls(band.band_gemm_dw)
    band.band_gemm_dx, band.band_gemm_dw = dx, dw
    try:
        torch.cuda.synchronize()
        ev[0].record()
        fa, fb = pair_features(model, config, batch)
        ev[1].record()
        grid_b = (fb.shape[1], fb.shape[2])
        k = resolve_band_width(config.nc_topk, grid_b)
        bands = []
        for a in (fa, torch.roll(fa, -1, 0)):
            corr = correlation_4d(a, fb)
            values, idx = band.topk_band(corr, k, values_from=mutual_matching(corr),
                                         mutual=config.nc_topk_mutual)
            bands.append((values.to(torch.bfloat16), idx))
        ev[2].record()
        filtered = [(sparse_neigh_consensus_apply(params, v, i, grid_b,
                                                  symmetric=config.symmetric_mode), i)
                    for v, i in bands]
        ev[3].record()
        pos, neg = (band_match_score_per_sample(
            band_mutual_matching(f, i, grid_b).float(), i, grid_b) for f, i in filtered)
        loss = neg.mean() - pos.mean()
        ev[4].record()
        loss.backward()
        ev[5].record()
        optimizer.step()
        ev[6].record()
        ev[6].synchronize()
    finally:
        band.band_gemm_dx, band.band_gemm_dw = dx.kernel, dw.kernel
    names = ("trunk", "correlation_mm_topk", "band_nc_forward", "band_mm_score_loss",
             "backward", "adam")
    out = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    out.update(backward_dx=dx.ms(dx.events), backward_dw=dw.ms(dw.events),
               backward_hit_lists=dw.ms(dw.hit_events),
               backward_dx_calls=len(dx.events), backward_dw_calls=len(dw.events),
               backward_hit_list_builds=len(dw.hit_events),
               hits_per_entry=dw.hits)
    out["backward_rest"] = (out["backward"] - out["backward_dx"] - out["backward_dw"]
                            - out["backward_hit_lists"])
    out["step"] = ev[0].elapsed_time(ev[6])
    return out


def band_objective(model, config, sel, objective, layer, dtype):
    """A scalar of the band NC stack on a fixed selection ``sel = (values,
    indices, grid_b)`` (float32, from the float32 pipeline), its values
    cast to ``dtype``: ``"score"``, minus the band match score of the
    positive pairs (the weak loss's positive term), or ``"linear"``, a
    fixed random functional of the NC stack's output. The selection is
    held fixed so that the float64 reference filters the same band."""
    from ncnet_tpu_torch.sparse import band_mutual_matching, sparse_neigh_consensus_apply
    from ncnet_tpu_torch.sparse.score import band_match_score_per_sample

    values, idx, grid_b = sel
    out = sparse_neigh_consensus_apply(
        model.neigh_consensus.params(), values.to(dtype), idx, grid_b,
        symmetric=config.symmetric_mode, layer=layer)
    if objective == "score":
        band = band_mutual_matching(out, idx, grid_b)
        return -band_match_score_per_sample(band, idx, grid_b).mean()
    r = torch.randn(out.shape, device=out.device, generator=torch.Generator(
        device=out.device).manual_seed(SEED + 9))
    return (out * r.to(dtype)).sum() / out.numel()


def band_grad_check(model, config, kernels):
    """NC gradients on the K = 50 band at the PF-Pascal width, 2 pairs,
    float32 through the kernels, against the plain band layer (gather,
    matmul and autograd) in float64 on the same selected band; the same
    plain version in float32 is reported beside it. Gated as the dense
    gradient check (GRAD_RATIO, GRAD_TOL)."""
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.ops.band import band_layer, band_layer_plain, topk_band
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching

    f32 = config.replace(half_precision=False, nc_topk=TRAIN_K)
    batch = synthetic_batch(2, SEED + 10)
    with torch.no_grad():
        fa = extract_features(model, f32, batch["source_image"])
        fb = extract_features(model, f32, batch["target_image"])
        corr = correlation_4d(fa, fb)
        values, idx = topk_band(corr, TRAIN_K, values_from=mutual_matching(corr),
                                mutual=True)
    sel = (values, idx, (fb.shape[1], fb.shape[2]))
    leaves = model.neigh_consensus.trainable()

    def grads(objective, layer, dtype):
        for t in leaves:
            t.grad = None
        loss = band_objective(model, f32, sel, objective, layer, dtype)
        loss.backward()
        return float(loss.detach()), [t.grad.clone() for t in leaves]

    checks = []
    for objective in ("linear", "score"):
        before = {n: k.launches for n, k in kernels.items()}
        loss_k, grads_k = grads(objective, band_layer, torch.float32)
        launched = {n: k.launches - before[n] for n, k in kernels.items()}
        loss_p, grads_p = grads(objective, band_layer_plain, torch.float64)
        _, grads_p32 = grads(objective, band_layer_plain, torch.float32)
        torch.cuda.empty_cache()
        for i, (gk, gp, g32) in enumerate(zip(grads_k, grads_p, grads_p32)):
            layer = grads_p[i - i % 2:i - i % 2 + 2]
            scale = max(float(t.abs().max()) for t in layer)
            err = float((gk.double() - gp).abs().max())
            err32 = float((g32.double() - gp).abs().max())
            checks.append({
                "objective": objective,
                "tensor": f"layer{i // 2}.{('kernel', 'bias')[i % 2]}",
                "max_abs_err": err, "scale": scale,
                "plain_f32_max_abs_err": err32, "loss": [loss_k, loss_p],
                "launches": launched,
                "ok": (bool(torch.isfinite(gk).all())
                       and err <= max(GRAD_RATIO * err32, GRAD_TOL * scale)
                       and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
                       and launched["band_gemm_fwd"] == 6
                       and launched["band_gemm_dx"] == 4
                       and launched["band_gemm_dw"] == 6)})
    for t in leaves:
        t.grad = None
    return checks


def full_k_step_check(model, config, kernels):
    """One float32 training step at 192 px (12x12 grids), 2 pairs, dense and
    on the complete band (K = 144), from the same NC weights: the losses
    agree to FULL_K_LOSS_TOL and the step's NC gradients to FULL_K_GRAD_TOL
    relative L2 error a layer (the max error relative to the layer's
    max is reported beside it); the NC weights are restored after."""
    from ncnet_tpu_torch.train.step import create_train_state, make_train_step

    batch = synthetic_batch(2, SEED + 11, FULL_K_HW)
    nc0 = [t.detach().clone() for t in model.neigh_consensus.trainable()]
    k = (FULL_K_HW[0] // 16) * (FULL_K_HW[1] // 16)
    runs = {}
    for name, topk in (("dense", 0), ("band", k)):
        with torch.no_grad():
            for t, t0 in zip(model.neigh_consensus.trainable(), nc0):
                t.copy_(t0)
        cfg = config.replace(half_precision=False, nc_topk=topk)
        state = create_train_state(model, 5e-4)
        before = {n: kk.launches for n, kk in kernels.items()}
        state, loss = make_train_step(cfg)(state, batch)
        torch.cuda.synchronize()
        runs[name] = (float(loss), [t.grad.clone() for t in
                                    state.optimizer.param_groups[0]["params"]],
                      {n: kk.launches - before[n] for n, kk in kernels.items()})
    with torch.no_grad():
        for t, t0 in zip(model.neigh_consensus.trainable(), nc0):
            t.copy_(t0)
    (loss_d, grads_d, launch_d), (loss_b, grads_b, launch_b) = runs["dense"], runs["band"]
    rel, rel_max = [], []
    for i in range(0, len(grads_d), 2):
        a = torch.cat([t.flatten() for t in grads_d[i:i + 2]])
        b = torch.cat([t.flatten() for t in grads_b[i:i + 2]])
        rel.append(float((a - b).norm() / a.norm()))
        rel_max.append(float((a - b).abs().max() / a.abs().max()))
    ok = (abs(loss_b - loss_d) <= FULL_K_LOSS_TOL and max(rel) <= FULL_K_GRAD_TOL
          and launch_b["band_gemm_fwd"] == 12 and launch_b["band_gemm_dx"] == 8
          and launch_b["band_gemm_dw"] == 12 and launch_d["conv4d_fwd"] == 6)
    return {"hw": list(FULL_K_HW), "k": k, "pairs": 2, "loss_dense": loss_d,
            "loss_band": loss_b, "grad_rel_l2_err_per_layer": rel,
            "grad_rel_max_err_per_layer": rel_max,
            "loss_tol": FULL_K_LOSS_TOL, "grad_tol_rel": FULL_K_GRAD_TOL,
            "launches_dense": launch_d, "launches_band": launch_b, "ok": ok}


def phase_train_band(smi, model, config, kernels):
    """Band training at the PF-Pascal config (K = 50): the gradient check;
    3 trainer steps at batch 16, bfloat16 (the slice's path; the counts
    are set to 0 just before and read just after), their launches, step
    times, stage breakdown and peak memory; one full-K step against
    dense; the synthetic convergence run at K = 16; the CLI with
    ``--nc_topk 50``. Returns ``{"train_band": launches of the 3 steps,
    "synthetic_band": launches of the synthetic run}``."""
    from ncnet_tpu_torch.data.loader import DataLoader
    from ncnet_tpu_torch.data.pairs import SyntheticPairDataset
    from ncnet_tpu_torch.eval import synthetic
    from ncnet_tpu_torch.train.checkpoint import load_checkpoint
    from ncnet_tpu_torch.train.step import (
        create_train_state,
        device_batch,
        make_train_step,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    grad_check = band_grad_check(model, config, kernels)
    if not all(c["ok"] for c in grad_check):
        emit({"phase": "train_band", "grad_check": grad_check})
        raise AssertionError(f"band NC gradients through the kernels disagree: "
                             f"{grad_check}")

    # (b) 3 trainer steps at the slice's configuration
    band_cfg = config.replace(half_precision=True, nc_topk=TRAIN_K)
    ds = SyntheticPairDataset(n=TRAIN_BATCH * (TRAIN_STEPS + 1),
                              output_size=SQUARE_HW, seed=SEED + 12)
    loader = DataLoader(ds, TRAIN_BATCH, shuffle=True, seed=SEED, num_workers=4,
                        drop_last=True)
    batches = [device_batch(b, "cuda") for b in loader.iter_epoch(0)]
    trunk0 = {k: v.clone() for k, v in model.feature_extraction.state_dict().items()}
    nc0 = [t.detach().clone() for t in model.neigh_consensus.trainable()]
    state = create_train_state(model, 5e-4)
    step = make_train_step(band_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for k in kernels.values():
        k.launches = 0
    for b in batches[:TRAIN_STEPS]:
        before = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append({n: k.launches - before[n] for n, k in kernels.items()})
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {n: 0 for n in kernels}
    want.update(band_gemm_fwd=12, band_gemm_dx=8, band_gemm_dw=12)
    problems = []
    if any(p != want for p in per_step):
        problems.append(f"launches per step {per_step} != {want}")
    if not all(l.dtype == torch.float32 and l.shape == () and bool(torch.isfinite(l))
               for l in losses):
        problems.append(f"losses not finite float32 scalars: {losses}")
    for t in state.optimizer.param_groups[0]["params"]:
        st = state.optimizer.state[t]
        if not (t.dtype == st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32):
            problems.append("master weights or Adam state not float32")
    moved = [float((t.detach() - t0).abs().max()) for t, t0 in
             zip(state.optimizer.param_groups[0]["params"], nc0)]
    # as in the dense phase, layer 3's bias may not move: its gradient is
    # one sum whose positive and negative terms cancel below bfloat16's
    # resolution on a random trunk
    if not all(m > 0 for m in moved[:-1]):
        problems.append(f"NC tensors other than layer 3's bias did not move: {moved}")
    if not all(torch.equal(v, trunk0[k])
               for k, v in model.feature_extraction.state_dict().items()):
        problems.append("the trunk changed")
    stages = band_train_stage_breakdown(model, band_cfg, batches[TRAIN_STEPS],
                                        state.optimizer)
    stages["peak_memory_bytes"] = peak
    if problems:
        emit({"phase": "train_band", "problems": problems, "stages_ms": stages})
        raise AssertionError("; ".join(problems))
    del batches, state
    torch.cuda.empty_cache()

    # (c) full K = dense, one float32 step at 192 px
    full_k = full_k_step_check(model, config, kernels)
    if not full_k["ok"]:
        emit({"phase": "train_band", "full_k": full_k})
        raise AssertionError(f"full-K band training != dense training: {full_k}")

    # (d) the synthetic convergence run on a K = 16 band
    before = {n: k.launches for n, k in kernels.items()}
    t0 = time.perf_counter()
    out = synthetic.run(device="cuda", nc_topk=SYNTH_BAND_K, verbose=False)
    synth = {k: out[k] for k in ("loss_first", "loss_last", "loss_deciles",
                                 "pck_before", "pck_after",
                                 "pck_diagonal_baseline")}
    synth.update(k=SYNTH_BAND_K, seconds=time.perf_counter() - t0,
                 launches={n: k.launches - before[n] for n, k in kernels.items()})
    synth["ok"] = (out["loss_last"] < out["loss_first"]
                   and out["pck_after"] >= out["pck_before"] + SYNTH_MARGIN
                   and out["pck_after"] >= out["pck_diagonal_baseline"] + SYNTH_MARGIN
                   and all(synth["launches"][n] > 0 for n in
                           ("band_gemm_fwd", "band_gemm_dx", "band_gemm_dw"))
                   and synth["launches"]["conv4d_fwd"] == 0)
    del out
    if not synth["ok"]:
        emit({"phase": "train_band", "synthetic": synth})
        raise AssertionError(f"synthetic convergence on the band not shown: {synth}")

    # (e) the CLI at the PF-Pascal config with --nc_topk 50
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "ncnet_tpu_torch.train", "--synthetic",
             "--allow_random_fe", "--nc_topk", str(TRAIN_K), "--max-steps",
             str(TRAIN_STEPS), "--result_model_dir", tmp],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        if proc.returncode != 0:
            raise AssertionError(f"band training CLI failed (rc {proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        ck = load_checkpoint(report["checkpoint"])
        cli = {k: report[k] for k in ("steps", "step_losses", "step_ms",
                                      "peak_memory_bytes", "kernel_launches")}
    cli_want = {n: 0 for n in report["kernel_launches"]}
    cli_want.update(band_gemm_fwd=12 * TRAIN_STEPS, band_gemm_dx=8 * TRAIN_STEPS,
                    band_gemm_dw=12 * TRAIN_STEPS)
    if not (report["steps"] == TRAIN_STEPS and ck.config.nc_topk == TRAIN_K
            and ck.config.nc_topk_mutual and report["kernel_launches"] == cli_want
            and all(np.isfinite(report["step_losses"]))):
        raise AssertionError(f"band training CLI report or checkpoint wrong: {cli}")
    emit({"phase": "train_band", "card": smi, "config": band_cfg.to_dict(),
          "batch": TRAIN_BATCH, "grad_check": grad_check,
          "losses": [float(l) for l in losses], "step_ms": step_ms,
          "launches_per_step": per_step, "launches": launches,
          "nc_param_max_move": moved, "stages_ms": stages, "full_k": full_k,
          "synthetic": synth, "cli": cli})
    return {"train_band": launches, "synthetic_band": synth["launches"]}


# -- trunk fine-tuning, the other trunks ------------------------------------


def first_layer_dx(kernels, dx_plain, dtype):
    """conv4d dx at the 1->16 layer (a 16->1 contraction of the 16-channel
    cotangent), at a fine-tuning step's shape (TRAIN_SAMPLES on 25^4, 5^4):
    against its plain version under TOL, repeated bitwise, the float32
    FFMA route also bit for bit the chain oracle; timed beside the plain
    version and the bound (the 1->16 forward's multiply-adds)."""
    from ncnet_tpu_torch.kernels.conv4d import flip_transpose, route

    shape = (TRAIN_SAMPLES, GRID, GRID, GRID, GRID)
    _, w, _ = nc_inputs((1, 1, 1, 1, 1), 1, 16, dtype, seed=300)
    gr = torch.randn(*shape, 16, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(301)).to(dtype)
    kern = lambda: kernels["conv4d_dx"](gr, w)  # noqa: E731
    ms = time_ms(kern, reps=3)
    plain_ms = time_ms(lambda: dx_plain(gr, w), reps=1)
    got, again = kern(), kern()
    bitwise = bool(torch.equal(got, again))
    del again
    oracle = (ffma_oracle_bitwise(kernels["conv4d_fwd"], got, gr, flip_transpose(w))
              if dtype == torch.float32 else None)
    want = dx_plain(gr.float(), w.float())
    got = got.float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = (bool(torch.isfinite(got).all()) and err <= TOL[dtype] * scale and bitwise
          and oracle is not False)
    bms, by, flops = bound_ms(shape, 1, 16, dtype, KSIZE)
    rec = {"layer": 0, "kernel": "conv4d_dx", "shape": list(shape), "cin": 1,
           "cout": 16, "contraction": "16->1", "dtype": str(dtype).split(".")[1],
           "route": route(dtype, 16, 1), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "gflop": flops / 1e9,
           "max_abs_err": err, "max_rel_err": err / scale, "tol_rel": TOL[dtype],
           "bitwise_repeat": bitwise, "oracle_bitwise": oracle, "ok": ok}
    if dtype == torch.float32:
        rec["ffma_bound_ms"] = ffma_bound_ms(flops)
    del got, want, gr
    torch.cuda.empty_cache()
    return rec


def band_first_layer_dx(kernels, model, config):
    """The band dx at the first band layer (16 cotangent channels into 1),
    K = 50 on one training batch's band, both passes, bfloat16: against
    `band_dx_plain` (per sample, float32 sums of the same inputs), repeated
    bitwise, timed beside the plain version and the bound."""
    from ncnet_tpu_torch.ops.band import band_dx_plain

    dtype = torch.bfloat16
    idx, grid_b = training_band(model, config, SEED + 21)
    out = []
    for name, geom in band_geometries(idx, grid_b).items():
        subs = sample_geometries(geom)
        hits = geom.hits((KSIZE,) * 4)
        n = geom.indices[0].numel()
        _, w, _ = band_layer_inputs(TRAIN_BATCH, n, 1, 16, dtype, seed=310)
        gen = torch.Generator(device="cuda").manual_seed(311)
        gp = torch.randn(TRAIN_BATCH, n, 16, generator=gen, device="cuda")
        gp = (gp * (torch.rand(gp.shape, generator=gen, device="cuda") > 0.5)).to(dtype)

        def per_sample(fn):
            return torch.cat([fn(gp[i:i + 1], g) for i, g in enumerate(subs)])

        kern = lambda: kernels["band_gemm_dx"](gp, w, hits)  # noqa: E731
        ms = time_ms(kern, reps=5)
        plain_ms = time_ms(lambda: per_sample(lambda gg, g: band_dx_plain(gg, w, g)), 1)
        got, again = kern(), kern()
        bitwise = bool(torch.equal(got, again))
        want = per_sample(lambda gg, g: band_dx_plain(gg.float(), w.float(), g))
        got = got.float()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok = (bool(torch.isfinite(got).all()) and err <= BAND_GRAD_TOL * scale
              and bitwise and got.shape == (TRAIN_BATCH, n, 1))
        out.append({"layer": 0, "kernel": "band_gemm_dx", "pass": name,
                    "shape": [TRAIN_BATCH, n], "cin": 1, "cout": 16,
                    "contraction": "16->1", "k": TRAIN_K, "dtype": "bfloat16",
                    "path": "finetune_band", "ms": ms, "plain_ms": plain_ms,
                    "max_abs_err": err, "max_rel_err": err / scale,
                    "tol_rel": BAND_GRAD_TOL, "bitwise_repeat": bitwise, "ok": ok,
                    **band_bound_ms(geom, 1, 16, dtype)})
        del subs, hits, got, again, want
        torch.cuda.empty_cache()
    return out


def tail_grad_check(model, config, state, band):
    """The trunk tail's gradients (every tensor of the trainable unit) of
    the weak loss's positive term, 2 pairs, float32 through the kernels,
    against the plain NC route (cuDNN conv3d, or the plain band layer) in
    float64 from the same float32 features; the plain route in float32
    beside it. Gated as the NC gradient check (GRAD_RATIO, GRAD_TOL). On
    the band the selection is held fixed and the band values are gathered
    from the differentiable correlation."""
    from ncnet_tpu_torch.models.immatchnet import extract_features, match_pipeline
    from ncnet_tpu_torch.ops.band import band_layer, band_layer_plain, topk_band
    from ncnet_tpu_torch.ops.conv4d import conv4d_plain
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.sparse import band_mutual_matching, sparse_neigh_consensus_apply
    from ncnet_tpu_torch.sparse.score import band_match_score_per_sample
    from ncnet_tpu_torch.train.loss import match_score

    f32 = config.replace(half_precision=False, nc_topk=TRAIN_K if band else 0)
    batch = synthetic_batch(2, SEED + 20)
    params = state.optimizer.param_groups[0]["params"]
    tail = [(p, t) for p, t in zip(state.paths, params) if p[0] == "fe_tail"]
    nc = model.neigh_consensus
    if band:
        with torch.no_grad():
            fa = extract_features(model, f32, batch["source_image"])
            fb = extract_features(model, f32, batch["target_image"])
            corr = correlation_4d(fa, fb)
            _, idx = topk_band(corr, TRAIN_K, values_from=mutual_matching(corr),
                               mutual=True)
        grid_b = (fb.shape[1], fb.shape[2])

    def grads(dtype, plain):
        for t in params:
            t.grad = None
        fa = extract_features(model, f32, batch["source_image"]).to(dtype)
        fb = extract_features(model, f32, batch["target_image"]).to(dtype)
        if band:
            corr = mutual_matching(correlation_4d(fa, fb))
            values = corr.reshape(*idx.shape[:3], -1).gather(-1, idx.long())
            out = sparse_neigh_consensus_apply(
                nc.params(), values, idx, grid_b, symmetric=f32.symmetric_mode,
                layer=band_layer_plain if plain else band_layer)
            loss = -band_match_score_per_sample(
                band_mutual_matching(out, idx, grid_b), idx, grid_b).mean()
        else:
            conv = nc.conv
            if plain:
                nc.conv = conv4d_plain
            try:
                loss = -match_score(match_pipeline(nc, f32, fa, fb))
            finally:
                nc.conv = conv
        loss.backward()
        return float(loss.detach()), [t.grad.clone() for _, t in tail]

    loss_k, gk_all = grads(torch.float32, False)
    loss_p, gp_all = grads(torch.float64, True)
    _, g32_all = grads(torch.float32, True)
    for t in params:
        t.grad = None
    checks = []
    for (path, _), gk, gp, g32 in zip(tail, gk_all, gp_all, g32_all):
        scale = float(gp.abs().max())
        err = float((gk.double() - gp.double()).abs().max())
        err32 = float((g32.double() - gp.double()).abs().max())
        checks.append({"tensor": "/".join(map(str, path)), "max_abs_err": err,
                       "scale": scale, "plain_f32_max_abs_err": err32,
                       "loss": [loss_k, loss_p],
                       "ok": (bool(torch.isfinite(gk).all())
                              and err <= max(GRAD_RATIO * err32, GRAD_TOL * scale)
                              and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p))})
    torch.cuda.empty_cache()
    return checks


def finetune_stage_breakdown(model, config, batch, optimizer, band):
    """CUDA-event times of one fine-tuning step: the trunk forward (its
    tail with grad), the pipeline forward with the loss (dense:
    correlation, MM, NC, MM, scores; band: correlation, MM, top-K, band NC,
    band MM, scores), the backward, and within it the first NC layer's dx
    launches and the trunk tail's backward (from the gradient's arrival at
    the features to the backward's end), then Adam; the step; the peak
    memory."""
    import ncnet_tpu_torch.ops.band as ops_band
    import ncnet_tpu_torch.ops.conv4d as ops_conv4d
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.train.loss import weak_loss_core

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    dx_events = []
    mod, attr = (ops_band, "band_gemm_dx") if band else (ops_conv4d, "conv4d_dx")
    real = getattr(mod, attr)

    def timed_dx(*args, real=real):
        w = args[1]
        first = w.shape[4] == 1  # the first layer: one input channel
        e0 = event() if first else None
        out = real(*args)
        if first:
            dx_events.append((e0, event()))
        return out

    hooks = []
    optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setattr(mod, attr, timed_dx)
    try:
        e0 = event()
        fa = extract_features(model, config, batch["source_image"])
        fb = extract_features(model, config, batch["target_image"])
        e1 = event()
        for f in (fa, fb):
            f.register_hook(lambda g: hooks.append(event()))
        loss = weak_loss_core(model.neigh_consensus, config, fa, fb)
        e2 = event()
        loss.backward()
        e3 = event()
        optimizer.step()
        e4 = event()
    finally:
        setattr(mod, attr, real)
    e4.synchronize()
    return {"trunk_forward_with_grad_tail": e0.elapsed_time(e1),
            "pipeline_forward_and_loss": e1.elapsed_time(e2),
            "backward": e2.elapsed_time(e3),
            "first_layer_dx": sum(a.elapsed_time(b) for a, b in dx_events),
            "first_layer_dx_launches": len(dx_events),
            "trunk_tail_backward": (max(h.elapsed_time(e3) for h in hooks)
                                    if hooks else None),
            "optimizer": e3.elapsed_time(e4), "step": e0.elapsed_time(e4),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "loss": float(loss.detach())}


def phase_finetune(smi, kernels, dx_plain, band):
    """Trunk fine-tuning (``--fe_finetune_params 1``) at the PF-Pascal
    config on its own model (seed 0; the other phases' trunk stays
    frozen): dense, or with ``band`` on the K = 50 band. The first NC
    layer's dx at the step's shape against its plain version (bitwise
    repeat); the tail's gradients through the kernels against the plain
    route; FT_BF16_STEPS bfloat16 steps and FT_F32_STEPS float32 steps at
    batch 16 (the counts set to 0 just before and read just after): finite
    losses, the first equal to the frozen-trunk loss on the same batch and
    weights, the tail unit moved and every other trunk tensor bitwise
    unchanged, the launches of every step; then the stage breakdown.
    Returns the steps' launches per kernel."""
    from ncnet_tpu_torch.train.loss import weak_loss
    from ncnet_tpu_torch.train.step import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    name = "finetune_band" if band else "finetune"
    model, config = build_model()
    cfg = config.replace(half_precision=True, nc_topk=TRAIN_K if band else 0)
    if band:
        dx_checks = band_first_layer_dx(kernels, model, config)
    else:
        dx_checks = [first_layer_dx(kernels, dx_plain, dt)
                     for dt in (torch.bfloat16, torch.float32)]
    if not all(c["ok"] for c in dx_checks):
        emit({"phase": name, "first_layer_dx": dx_checks})
        raise AssertionError(f"the first layer's dx disagrees: {dx_checks}")
    batches = [synthetic_batch(TRAIN_BATCH, SEED + 30 + i)
               for i in range(FT_BF16_STEPS + FT_F32_STEPS + 1)]
    with torch.no_grad():
        frozen_loss = weak_loss(model, cfg, batches[0])
    trunk0 = {k: v.clone() for k, v in model.feature_extraction.state_dict().items()}
    state = create_train_state(model, 5e-4, fe_finetune_blocks=FT_BLOCKS)
    tail_prefix = f"layer3.{len(model.feature_extraction.layer3) - FT_BLOCKS}."
    grad_check = tail_grad_check(model, config, state, band)
    if not all(c["ok"] for c in grad_check):
        emit({"phase": name, "tail_grad_check": grad_check})
        raise AssertionError(f"the trunk tail's gradients disagree: {grad_check}")
    steps = ([make_train_step(cfg, fe_finetune_blocks=FT_BLOCKS)] * FT_BF16_STEPS
             + [make_train_step(cfg.replace(half_precision=False),
                                fe_finetune_blocks=FT_BLOCKS)] * FT_F32_STEPS)
    if band:
        want = {n: 0 for n in kernels}
        want.update(band_gemm_fwd=12, band_gemm_dx=12, band_gemm_dw=12)
    else:
        want = {n: 0 for n in kernels}
        want.update(conv4d_fwd=6, conv4d_dx=6, conv4d_dw=6)
    torch.cuda.synchronize()
    losses, step_ms, per_step = [], [], []
    for k in kernels.values():
        k.launches = 0
    for step, b in zip(steps, batches):
        before = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append({n: k.launches - before[n] for n, k in kernels.items()})
    launches = {n: k.launches for n, k in kernels.items()}
    problems = []
    if any(p != want for p in per_step):
        problems.append(f"launches per step {per_step} != {want}")
    if not all(bool(torch.isfinite(l)) for l in losses):
        problems.append(f"losses not finite: {losses}")
    first = float(losses[0])
    frozen_match = {"frozen_loss": float(frozen_loss), "finetune_loss": first,
                    "bitwise": bool(torch.equal(losses[0], frozen_loss)),
                    "rel_err": abs(first - float(frozen_loss))
                    / max(abs(float(frozen_loss)), 1e-30)}
    if not (frozen_match["bitwise"] or frozen_match["rel_err"] <= SERVE_TOL):
        problems.append(f"first loss is not the frozen-trunk loss: {frozen_match}")
    moved, unchanged = [], []
    for k, v in model.feature_extraction.state_dict().items():
        (moved if k.startswith(tail_prefix) else unchanged).append(
            not torch.equal(v, trunk0[k]))
    if not (moved and all(moved)):
        problems.append(f"tail tensors moved: {sum(moved)} of {len(moved)}")
    if any(unchanged):
        problems.append(f"{sum(unchanged)} trunk tensors outside the tail changed")
    stages = finetune_stage_breakdown(model, cfg, batches[-1], state.optimizer, band)
    emit({"phase": name, "card": smi, "config": cfg.to_dict(),
          "fe_finetune_blocks": FT_BLOCKS, "batch": TRAIN_BATCH,
          "trainable_tensors": len(state.paths), "first_layer_dx": dx_checks,
          "tail_grad_check": grad_check, "losses": [float(l) for l in losses],
          "step_dtypes": ["bfloat16"] * FT_BF16_STEPS + ["float32"] * FT_F32_STEPS,
          "step_ms": step_ms, "launches_per_step": per_step, "launches": launches,
          "frozen_loss_check": frozen_match, "tail_tensors_moved": len(moved),
          "stages_ms": stages, "seconds": time.perf_counter() - t_phase})
    if problems:
        raise AssertionError("; ".join(problems))
    del model, state
    torch.cuda.empty_cache()
    return launches, dx_checks


def phase_trunks(smi, kernels, conv4d_plain):
    """VGG-16 and DenseNet-201 at the PF-Pascal width (400 px, NC 5-5-5 /
    16-16-1), random weights from seed 0: a float32 4-pair serving batch
    through the kernels against the plain conv4d (each pair's readouts up
    to ties), the trunk's ms a serving batch (8 images), one bfloat16
    training step at batch 16 with the trunk frozen and one with its last
    tail unit trainable, each with a finite loss. Returns the launches."""
    from ncnet_tpu_torch.models.immatchnet import (
        ImMatchNet,
        ImMatchNetConfig,
        extract_features,
        immatchnet_apply,
    )
    from ncnet_tpu_torch.train.step import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out, launches = {}, {n: 0 for n in kernels}
    image = image_maker(SEED + 40)
    src = torch.from_numpy(np.stack([image(SQUARE_HW) for _ in range(MAX_BATCH)])).cuda()
    tgt = torch.from_numpy(np.stack([image(SQUARE_HW) for _ in range(MAX_BATCH)])).cuda()
    batch = synthetic_batch(TRAIN_BATCH, SEED + 41)
    for cnn in ("vgg", "densenet201"):
        t0 = time.perf_counter()
        cfg = ImMatchNetConfig(feature_extraction_cnn=cnn, ncons_kernel_sizes=(5, 5, 5),
                               ncons_channels=(16, 16, 1), symmetric_mode=True)
        model = ImMatchNet(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
        nc = model.neigh_consensus
        before = {n: k.launches for n, k in kernels.items()}
        with torch.inference_mode():
            corr_k = immatchnet_apply(model, cfg, src, tgt)
            conv, nc.conv = nc.conv, conv4d_plain
            try:
                corr_p = immatchnet_apply(model, cfg, src, tgt)
            finally:
                nc.conv = conv
            agree = [argmax_agrees(corr_k[i:i + 1], corr_p[i:i + 1])
                     for i in range(MAX_BATCH)]
            corr_err = float((corr_k - corr_p).abs().max() / corr_p.abs().max())
            trunk_ms = time_ms(lambda: extract_features(
                model, cfg, torch.cat([src, tgt])), reps=3)
        del corr_k, corr_p
        rec = {"trunk_channels": model.feature_extraction.channels,
               "serve_batch": MAX_BATCH, "readouts_agree": agree,
               "corr_max_rel_err": corr_err, "trunk_ms_per_batch": trunk_ms,
               "trunk_images": 2 * MAX_BATCH}
        bf16 = cfg.replace(half_precision=True)
        for blocks in (0, 1):
            state = create_train_state(model, 5e-4, fe_finetune_blocks=blocks)
            state, loss = make_train_step(bf16, fe_finetune_blocks=blocks)(state, batch)
            rec[f"train_loss_fe_finetune_{blocks}"] = float(loss)
        torch.cuda.synchronize()
        got = {n: k.launches - before[n] for n, k in kernels.items()}
        for n in kernels:
            launches[n] += got[n]
        # the kernel forward (3, the symmetric pass batched) and the two
        # steps (frozen: 6 / 4 / 6; the tail trainable: 6 / 6 / 6)
        want = {n: 0 for n in kernels}
        want.update(conv4d_fwd=15, conv4d_dx=10, conv4d_dw=12)
        rec.update(launches=got, seconds=time.perf_counter() - t0)
        out[cnn] = rec
        del model, state
        torch.cuda.empty_cache()
        if not (all(agree) and corr_err <= SERVE_TOL and got == want
                and all(np.isfinite(rec[f"train_loss_fe_finetune_{b}"]) for b in (0, 1))):
            emit({"phase": "trunks", "card": smi, "trunks": out})
            raise AssertionError(f"the {cnn} trunk failed: {rec}")
    emit({"phase": "trunks", "card": smi, "hw": list(SQUARE_HW),
          "trunks": out, "launches": launches})
    return launches


# -- the streamed band, streamed band training, refinement ------------------


def peak_call(fn):
    """``(result, ms, peak bytes above the memory held before)`` of one call
    of ``fn`` after a warm-up call; ms by CUDA events."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop), torch.cuda.max_memory_allocated() - base


def unit_features(shape, seed, dtype=torch.float32):
    """L2-normalized random features on the card (a trunk's output)."""
    from ncnet_tpu_torch.ops.norm import feature_l2norm

    g = torch.Generator(device="cuda").manual_seed(seed)
    return feature_l2norm(torch.randn(*shape, generator=g, device="cuda")).to(dtype)


def stream_vs_dense(fa, fb, k, mutual, tile, slab_gate=True):
    """The streamed band against the dense band of one feature pair: gate
    (a) (bitwise the band of the slabs' correlation, skipped where that
    volume would be a second dense run), gate (b) (`correlation_4d`'s
    band: values at STREAM_RTOL / STREAM_ATOL on the rows whose indices
    agree, every swap a near tie), a bitwise repeat, and each route's ms
    and peak memory."""
    from ncnet_tpu_torch.ops.band import topk_band
    from ncnet_tpu_torch.ops.corr_stream import (
        band_index_swaps,
        corr_stream_band,
        slab_correlation,
    )
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching

    def dense():
        corr = correlation_4d(fa, fb)
        return topk_band(corr, k, values_from=mutual_matching(corr), mutual=mutual)

    with torch.no_grad():
        (sv, si), s_ms, s_peak = peak_call(
            lambda: corr_stream_band(fa, fb, k, mutual=mutual, tile=tile))
        again = corr_stream_band(fa, fb, k, mutual=mutual, tile=tile)
        repeat = bool(torch.equal(sv, again[0]) and torch.equal(si, again[1]))
        del again
        (dv, di), d_ms, d_peak = peak_call(dense)
        rec = {"shape_a": list(fa.shape), "shape_b": list(fb.shape), "k": k,
               "mutual": mutual, "tile": tile, "dtype": str(fa.dtype)[6:],
               "stream_ms": s_ms, "stream_peak_bytes": s_peak,
               "dense_ms": d_ms, "dense_peak_bytes": d_peak,
               "bitwise_repeat": repeat}
        corr_s = slab_correlation(fa, fb, tile)
        if slab_gate:
            wv, wi = topk_band(corr_s, k, values_from=mutual_matching(corr_s),
                               mutual=mutual)
            view = torch.int32 if sv.dtype == torch.float32 else torch.int16
            rec["slab_band_bitwise"] = bool(torch.equal(si, wi) and torch.equal(
                sv.view(view), wv.view(view)))
            del wv, wi
        corr = correlation_4d(fa, fb)
        swaps = band_index_swaps(corr, corr_s, si, di)
        del corr, corr_s
        same = (si == di).all(-1, keepdim=True).expand_as(si)
        err = (sv[same].float() - dv[same].float()).abs()
        bound = STREAM_ATOL + STREAM_RTOL * dv[same].float().abs()
        rec.update(swaps=swaps, values_within_tol=bool((err <= bound).all()),
                   max_abs_err=float(err.max()) if err.numel() else 0.0,
                   index_bitwise=bool(torch.equal(si, di)),
                   value_bitwise=bool(torch.equal(sv, dv)))
    rec["ok"] = (repeat and rec.get("slab_band_bitwise", True)
                 and swaps["near_ties"] == swaps["entries"]
                 and (rec["values_within_tol"] or fa.dtype != torch.float32))
    return rec


def stream_grad_check():
    """The stream's gradient (`CorrStreamBand.backward`) against the port's
    autograd through the dense band, float32, at batch 2 of band training's
    shape: ``d feat_a`` and ``d feat_b`` of a random linear functional of
    the K = 50 mutual band's values, within STREAM_GRAD_TOL of each one's
    scale (random features: no tied maxima, where the two routings
    differ)."""
    from ncnet_tpu_torch.ops.band import topk_band
    from ncnet_tpu_torch.ops.corr_stream import corr_stream_band
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching

    fa0 = unit_features((2, GRID, GRID, 1024), SEED + 40)
    fb0 = unit_features((2, GRID, GRID, 1024), SEED + 41)
    g = torch.Generator(device="cuda").manual_seed(SEED + 42)
    ct = torch.randn(2, GRID, GRID, TRAIN_K, generator=g, device="cuda")

    def grads(band_fn):
        a, b = fa0.clone().requires_grad_(), fb0.clone().requires_grad_()
        values, idx = band_fn(a, b)
        (values * ct).sum().backward()
        return a.grad, b.grad, idx

    def dense(a, b):
        corr = correlation_4d(a, b)
        return topk_band(corr, TRAIN_K, values_from=mutual_matching(corr),
                         mutual=True)

    t0 = time.perf_counter()
    gs = grads(lambda a, b: corr_stream_band(a, b, TRAIN_K, mutual=True))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    again = grads(lambda a, b: corr_stream_band(a, b, TRAIN_K, mutual=True))
    gd = grads(dense)
    rec = {"shape": [2, GRID, GRID, 1024], "k": TRAIN_K, "mutual": True,
           "tol_rel": STREAM_GRAD_TOL, "stream_backward_s": stream_s,
           "same_band": bool(torch.equal(gs[2], gd[2])),
           "bitwise_repeat": all(torch.equal(x, y) for x, y in zip(gs[:2], again[:2]))}
    for name, s, d in (("d_feat_a", gs[0], gd[0]), ("d_feat_b", gs[1], gd[1])):
        scale = float(d.abs().max())
        rec[name] = {"max_abs_err": float((s - d).abs().max()), "scale": scale}
    rec["ok"] = (rec["same_band"] and rec["bitwise_repeat"] and all(
        rec[n]["max_abs_err"] <= STREAM_GRAD_TOL * rec[n]["scale"]
        for n in ("d_feat_a", "d_feat_b")))
    return rec


def phase_stream(smi):
    """The streamed band at full width: (a) band training's shape (16 pairs,
    25x25, c = 1024, K = 50), mutual on and off, tile 128 and 96 (which
    does not divide 625), float32 by gates (a) and (b), bitwise repeats;
    the same in bfloat16 (training's dtype) at tile 128; (b) one InLoc-sized
    pair (200x150 against 150x200 features, K = 16), non-mutual and
    mutual, float32, gate (b), ms and peak memory of both routes; (c) the
    stream's gradient against the dense band's autograd at batch 2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pf = []
    fa = unit_features((TRAIN_BATCH, GRID, GRID, 1024), SEED + 30)
    fb = unit_features((TRAIN_BATCH, GRID, GRID, 1024), SEED + 31)
    for mutual in (False, True):
        for tile in STREAM_TILES:
            pf.append(stream_vs_dense(fa, fb, TRAIN_K, mutual, tile))
        pf.append(stream_vs_dense(fa.to(torch.bfloat16), fb.to(torch.bfloat16),
                                  TRAIN_K, mutual, STREAM_TILES[0]))
    del fa, fb
    fa = unit_features((1,) + INLOC_GRID + (1024,), SEED + 32)
    fb = unit_features((1,) + INLOC_GRID[::-1] + (1024,), SEED + 33)
    inloc_pair = [stream_vs_dense(fa, fb, INLOC_BAND_K, mutual, STREAM_TILES[0],
                                  slab_gate=False) for mutual in (False, True)]
    del fa, fb
    torch.cuda.empty_cache()
    grad = stream_grad_check()
    record = {"phase": "stream", "card": smi, "pf_pascal_training_shape": pf,
              "inloc_pair": inloc_pair, "grad_check": grad,
              "tol": {"rtol": STREAM_RTOL, "atol": STREAM_ATOL,
                      "grad_rel": STREAM_GRAD_TOL}}
    emit(record)
    bad = [r for r in pf + inloc_pair + [grad] if not r["ok"]]
    if bad:
        raise AssertionError(f"the streamed band disagrees: {bad}")
    return record


def run_steps(model, cfg, batches, kernels, from_features=False, **mode):
    """Trainer steps (`create_train_state` / `make_train_step` with ``mode``;
    ``from_features``: the batches are cached features) over ``batches``
    with the counts set to 0 just before: losses, step ms, per-step and
    total launches, the trainable tensors before and after, the peak
    memory."""
    from ncnet_tpu_torch.train.step import create_train_state, make_train_step

    state = create_train_state(model, 5e-4, **mode)
    step = make_train_step(cfg, from_features=from_features, **mode)
    before = [t.detach().clone() for t in state.optimizer.param_groups[0]["params"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    losses, step_ms, per_step = [], [], []
    for b in batches:
        was = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append({n: k.launches - was[n] for n, k in kernels.items()})
    moved = [float((t.detach() - t0).abs().max()) for t, t0 in
             zip(state.optimizer.param_groups[0]["params"], before)]
    return {"losses": losses, "step_ms": step_ms, "launches_per_step": per_step,
            "launches": {n: k.launches for n, k in kernels.items()},
            "moved": moved, "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def phase_train_stream(smi, config, kernels):
    """Band training with the streamed band (``--nc_topk 50 --corr-impl
    stream``) at the PF-Pascal config: 3 bfloat16 steps at batch 16 against
    the same steps with ``--corr-impl dense`` from the same weights (the
    losses within TRAIN_STREAM_LOSS_TOL; every NC tensor but layer 3's
    bias moved; 12 band forward, 8 dx and 12 dw launches a step, the
    counts set to 0 just before); then one fine-tuning step
    (``--fe_finetune_params 1``), whose backward runs through the stream's
    VJP into the trunk: 12 forward, 12 dx, 12 dw launches, the tail moved.
    Returns the launches of the stream's steps and of the fine-tuning
    step."""
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet

    dense_cfg = config.replace(half_precision=True, nc_topk=TRAIN_K)
    stream_cfg = dense_cfg.replace(corr_impl="stream")
    batches = [synthetic_batch(TRAIN_BATCH, SEED + 50 + i) for i in range(TRAIN_STEPS + 1)]
    runs = {}
    for name, cfg in (("dense", dense_cfg), ("stream", stream_cfg)):
        model = ImMatchNet(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(SEED))
        runs[name] = run_steps(model, cfg, batches[:TRAIN_STEPS], kernels)
        del model
        torch.cuda.empty_cache()
    model = ImMatchNet(stream_cfg, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    ft = run_steps(model, stream_cfg, batches[TRAIN_STEPS:], kernels,
                   fe_finetune_blocks=FT_BLOCKS)
    del model
    torch.cuda.empty_cache()
    want = {n: 0 for n in kernels}
    want.update(band_gemm_fwd=12, band_gemm_dx=8, band_gemm_dw=12)
    ft_want = dict(want, band_gemm_dx=12)
    s, d = runs["stream"], runs["dense"]
    gaps = [abs(a - b) for a, b in zip(s["losses"], d["losses"])]
    problems = []
    if any(p != want for p in s["launches_per_step"] + d["launches_per_step"]):
        problems.append(f"launches per step {s['launches_per_step']} != {want}")
    if ft["launches_per_step"] != [ft_want]:
        problems.append(f"fine-tuning launches {ft['launches_per_step']} != {ft_want}")
    if not all(np.isfinite(s["losses"] + d["losses"] + ft["losses"])):
        problems.append("a loss is not finite")
    if not all(g <= TRAIN_STREAM_LOSS_TOL for g in gaps):
        problems.append(f"stream vs dense losses differ by {gaps}")
    if not all(m > 0 for m in s["moved"][:-1]):
        problems.append(f"NC tensors other than layer 3's bias did not move: {s['moved']}")
    if not all(m > 0 for m in ft["moved"][len(s["moved"]):]):
        problems.append(f"the trunk's tail did not move: {ft['moved']}")
    emit({"phase": "train_stream", "card": smi, "config": stream_cfg.to_dict(),
          "batch": TRAIN_BATCH, "stream": s, "dense": d, "loss_gaps": gaps,
          "loss_tol": TRAIN_STREAM_LOSS_TOL, "finetune": ft})
    if problems:
        raise AssertionError("; ".join(problems))
    return {"train_stream": s["launches"], "finetune_stream": ft["launches"]}


class RecordingLadder:
    """A `QualityLadder` that records its rung after every update."""

    def __init__(self, **kw):
        from ncnet_tpu_torch.serve.resilience import QualityLadder

        self.ladder = QualityLadder(**kw)
        self.rungs = [self.ladder.rung]

    def __getattr__(self, name):
        return getattr(self.ladder, name)

    def update(self, pressure):
        out = self.ladder.update(pressure)
        if self.ladder.rung != self.rungs[-1]:
            self.rungs.append(self.ladder.rung)
        return out


def refine_serve(model, config, kernels):
    """The refined serving ladder: dense standard, K = BAND_K band degraded,
    refined (factor REFINE_PF, coarse band REFINE_TOPK) above them, all
    warmed on the 400 px square bucket; REFINE_PINNED requests pinned to
    each rung, then REFINE_BURST unpinned ones at once under a ladder with
    a low high-water mark, whose every rung change must be one step."""
    from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
    from ncnet_tpu_torch.serve.step import make_serve_match_step

    image = image_maker(SEED + 60)
    payloads = [{"source_image": image(SQUARE_HW), "target_image": image(SQUARE_HW)}
                for _ in range(REFINE_PINNED)]
    key = (SQUARE_HW, SQUARE_HW)
    refined_cfg = config.replace(refine_factor=REFINE_PF, refine_topk=REFINE_TOPK)
    from ncnet_tpu_torch.serve.engine import QUEUE_LIMIT

    # cheaper at 4 queued requests or batches, richer again at 1 or none
    # (the engine's pressure counts a flushed batch once)
    ladder = RecordingLadder(rungs=("refined", "standard", "degraded"),
                             start="refined", high=4 / QUEUE_LIMIT,
                             low=1 / QUEUE_LIMIT, up_count=1, down_count=2)
    variants = ("refined", "standard", "degraded")
    with ServeEngine(make_serve_match_step(config), model, device="cuda",
                     max_batch=MAX_BATCH,
                     degraded_apply_fn=make_serve_match_step(
                         config.replace(nc_topk=BAND_K)),
                     refined_apply_fn=make_serve_match_step(refined_cfg),
                     quality_controller=ladder) as engine:
        t0 = time.perf_counter()
        warm = engine.warmup([(key, payload_spec(payloads[0]))])
        warm_s = time.perf_counter() - t0
        for k in kernels.values():
            k.launches = 0
        pinned = {v: [engine.submit(key=key, payload=p, variant=v) for p in payloads]
                  for v in variants}
        results = {v: [f.result(timeout=600) for f in fs] for v, fs in pinned.items()}
        pinned_launches = {n: k.launches for n, k in kernels.items()}
        pinned_report = engine.report()
        burst = [engine.submit(key=key, payload=payloads[i % REFINE_PINNED])
                 for i in range(REFINE_BURST)]
        burst_results = [f.result(timeout=600) for f in burst]
        time.sleep(0.5)  # idle dispatch loops: the ladder climbs back
        report = engine.report()
    steps = [b - a for a, b in zip(ladder.rungs, ladder.rungs[1:])]
    # a square batch: 3 conv4d launches (standard), 6 band (degraded, and
    # the refined program's coarse band)
    n = {"refined": pinned_report["refined_batches"],
         "degraded": pinned_report["degraded_batches"]}
    n["standard"] = pinned_report["batches"] - n["refined"] - n["degraded"]
    want = {"conv4d_fwd": 3 * n["standard"],
            "band_gemm_fwd": 6 * (n["degraded"] + n["refined"])}
    problems = []
    for v, rs in results.items():
        if not all(np.isfinite(r["matches"]).all() for r in rs):
            problems.append(f"{v}: non-finite matches")
    if not all(np.isfinite(r["matches"]).all() for r in burst_results):
        problems.append("burst: non-finite matches")
    if any(pinned_launches[k] != v for k, v in want.items()):
        problems.append(f"pinned launches {pinned_launches} != {want}")
    if not all(n[v] > 0 for v in variants):
        problems.append(f"pinned batches by rung: {n}")
    if not (steps and all(abs(s) == 1 for s in steps) and len(steps) >= 2):
        problems.append(f"ladder rungs {ladder.rungs}: not one rung a flip")
    if report["failed"] or report["completed"] != 3 * REFINE_PINNED + REFINE_BURST:
        problems.append(f"served {report}")
    return {"warm_runs": warm, "warm_s": warm_s, "pinned_batches": n,
            "pinned_launches": pinned_launches,
            "ladder_rungs": ladder.rungs, "ladder_flips": ladder.flips,
            "report": {k: report[k] for k in (
                "completed", "batches", "refined_batches", "degraded_batches",
                "degrade_flips", "variant", "pairs_per_s", "latency_p50_ms",
                "latency_p95_ms")},
            "refined_differs_from_standard": bool(not np.array_equal(
                results["refined"][0]["matches"], results["standard"][0]["matches"])),
            "problems": problems}


def refine_stage_breakdown(model, config, batch, reps=3):
    """CUDA-event times of the refined serving forward's stages on one
    square batch (``config`` refined), each timed alone after a warm-up:
    trunk, pool, the coarse band pipeline (selection, band NC, MM), the
    window re-score, the densify; the whole forward dense-selected and
    streamed (``corr_impl='stream'``) with each one's peak memory."""
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.refine import pool_features, refine_rescore
    from ncnet_tpu_torch.serve.step import make_serve_match_step
    from ncnet_tpu_torch.sparse import sparse_corr_to_dense, sparse_match_pipeline

    r = config.refine_factor
    coarse = config.replace(refine_factor=0, nc_topk=config.refine_topk)
    params = model.neigh_consensus.params()
    with torch.inference_mode():
        fa = extract_features(model, config, batch["source_image"])
        fb = extract_features(model, config, batch["target_image"])
        fa_lo, fb_lo = pool_features(fa, r), pool_features(fb, r)
        values, indices, grid_lo = sparse_match_pipeline(params, coarse, fa_lo, fb_lo)
        fine = refine_rescore(values, indices, grid_lo, fa, fb, r,
                              radius=config.refine_radius)
        stages = {
            "pairs": int(fa.shape[0]),
            "trunk": time_ms(lambda: (
                extract_features(model, config, batch["source_image"]),
                extract_features(model, config, batch["target_image"])), reps),
            "pool": time_ms(lambda: (pool_features(fa, r), pool_features(fb, r)), reps),
            "coarse_band": time_ms(lambda: sparse_match_pipeline(
                params, coarse, fa_lo, fb_lo), reps),
            "rescore": time_ms(lambda: refine_rescore(
                values, indices, grid_lo, fa, fb, r, radius=config.refine_radius), reps),
            "densify": time_ms(lambda: sparse_corr_to_dense(*fine), reps),
        }
        for name, cfg in (("forward", config),
                          ("forward_stream", config.replace(corr_impl="stream"))):
            apply = make_serve_match_step(cfg)
            _, ms, peak = peak_call(lambda: apply(model, batch))
            stages[name], stages[f"{name}_peak_bytes"] = ms, peak
    return stages


def coarse_band_kernels(model, cfg, batch, kernels, grads, path):
    """The band kernels on the coarse band a refined pipeline gives them
    (``batch``'s features pooled by the refine factor, the mutual top-K at
    ``refine_topk``), both passes, every layer: the forward (and with
    ``grads`` dx of layers 2 and 3, and dw) against their plain versions
    in float32, repeated bitwise, timed beside the plain version and the
    bound. Returns ``{"fwd", "dx", "dw"}`` record lists."""
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.ops.band import (
        band_dw_plain,
        band_dx_plain,
        band_layer_plain,
        topk_band,
    )
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching
    from ncnet_tpu_torch.refine import pool_features

    dtype = torch.bfloat16 if cfg.half_precision else torch.float32
    with torch.no_grad():
        fa, fb = (pool_features(extract_features(model, cfg, batch[k]),
                                cfg.refine_factor)
                  for k in ("source_image", "target_image"))
        corr = correlation_4d(fa, fb)
        _, idx = topk_band(corr, cfg.refine_topk,
                           values_from=mutual_matching(corr), mutual=True)
    grid_b = (fb.shape[1], fb.shape[2])
    fwd, dx, dw = (kernels[n] for n in ("band_gemm_fwd", "band_gemm_dx", "band_gemm_dw"))
    kernel = (KSIZE,) * 4
    out = {"fwd": [], "dx": [], "dw": []}
    b = idx.shape[0]
    for name, geom in band_geometries(idx, grid_b).items():
        n = geom.indices[0].numel()
        hits = geom.hits(kernel) if grads else None
        for li, (cin, cout) in enumerate(NC_LAYERS):
            x, w, bias = band_layer_inputs(b, n, cin, cout, dtype, seed=170 + li)
            gen = torch.Generator(device="cuda").manual_seed(180 + li)
            gp = (torch.randn(b, n, cout, generator=gen, device="cuda")).to(dtype)
            runs = [("fwd", lambda: band_kernel_call(fwd, x, w, bias, geom),
                     lambda: band_layer_plain(x, w, bias, geom),
                     lambda: band_layer_plain(x.float(), w.float(),
                                              bias.to(dtype).float(), geom))]
            if grads:
                runs.append(("dw", lambda: dw(x, gp, hits),
                             lambda: band_dw_plain(x, gp, geom, kernel),
                             lambda: band_dw_plain(x, gp, geom, kernel)))
                if li > 0:
                    runs.append(("dx", lambda: dx(gp, w, hits),
                                 lambda: band_dx_plain(gp, w, geom),
                                 lambda: band_dx_plain(gp.float(), w.float(), geom)))
            for kname, kern, plain, reference in runs:
                ms = time_ms(kern, reps=5)
                plain_ms = time_ms(plain, reps=2)
                got, again = kern(), kern()
                bitwise = bool(torch.equal(got, again))
                got, want = got.float(), reference().float()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                tol = BAND_TOL[dtype] if kname == "fwd" else BAND_GRAD_TOL
                ok = bool(torch.isfinite(got).all()) and err <= tol * scale and bitwise
                out[kname].append({
                    "layer": li, "pass": name, "shape": [b, n], "cin": cin,
                    "cout": cout, "k": cfg.refine_topk, "grid_b": list(grid_b),
                    "dtype": str(dtype)[6:], "path": path, "ms": ms,
                    "plain_ms": plain_ms, "max_abs_err": err,
                    "max_rel_err": err / scale, "tol_rel": tol,
                    "bitwise_repeat": bitwise, "ok": ok,
                    **band_bound_ms(geom, cin, cout, dtype)})
                if not ok:
                    emit({"phase": "refine", "coarse_band_kernels": out})
                    raise AssertionError(f"band {kname} kernel disagrees on the "
                                         f"coarse band of {path}: {out[kname][-1]}")
    return out


def refine_inloc(kernels):
    """The InLoc dump at 3200 px with ``--k_size 1 --refine 2 --refine_topk
    16`` (NC 3-3 / 16-1, bfloat16) on one generated query and two panos:
    the .mat, its seconds, the launches (4 band forward a pair, no conv4d)
    and the peak memory."""
    from scipy.io import loadmat

    from ncnet_tpu_torch.data.images import resize_bilinear_np, to_uint8_image
    from ncnet_tpu_torch.eval import inloc
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig

    config = ImMatchNetConfig(
        feature_extraction_cnn="resnet101", ncons_kernel_sizes=(3, 3),
        ncons_channels=(16, 1), half_precision=True, relocalization_k_size=1,
        refine_factor=2, refine_topk=16)
    model = ImMatchNet(config, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED + 8)
    query = texture(rng, QUERY_HW, 24)
    qh, qw = QUERY_HW
    panos = [to_uint8_image(resize_bilinear_np(
                 query[int(0.3 * qh):int(0.67 * qh), int(0.17 * qw):int(0.83 * qw)],
                 *PANO_HW)),
             texture(rng, PANO_HW, 8)]
    n_slots = inloc.n_match_slots(INLOC_SIZE, 1, True)
    with tempfile.TemporaryDirectory() as root:
        np.save(os.path.join(root, "query.npy"), query)
        names = []
        for i, pano in enumerate(panos):
            names.append(f"pano{i}.npy")
            np.save(os.path.join(root, names[-1]), pano)
        shortlist = os.path.join(root, "shortlist.mat")
        write_shortlist(shortlist, [("query.npy", names)])
        out_dir = os.path.join(root, "matches")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        done = inloc.dump_matches(
            model, config, shortlist, root, root, out_dir,
            image_size=INLOC_SIZE, n_queries=1, n_panos=len(panos),
            verbose=False, read_image=lambda p: np.load(p).astype(np.float32))
        dump_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        m = loadmat(os.path.join(out_dir, "1.mat"))["matches"]
    filled = [int((np.abs(m[0, p]).sum(axis=1) > 0).sum()) for p in range(len(panos))]
    want = {n: 0 for n in kernels}
    want["band_gemm_fwd"] = 4 * len(panos)
    problems = []
    if m.shape != (1, len(panos), n_slots, 5):
        problems.append(f"refined .mat {m.shape}, want (1, 2, {n_slots}, 5)")
    if not (np.isfinite(m).all() and (m[..., :4] >= 0).all() and (m[..., :4] <= 1).all()):
        problems.append("refined .mat: non-finite or out-of-range matches")
    if not all(0 < f <= n_slots for f in filled) or done["pairs"] != len(panos):
        problems.append(f"refined .mat filled slots {filled}")
    if launches != want:
        problems.append(f"refined InLoc launches {launches} != {want}")
    return {"config": config.to_dict(), "mat_shape": list(m.shape), "filled": filled,
            "dump_s": dump_s, "s_per_pair": dump_s / len(panos),
            "launches": launches, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "problems": problems}


def phase_refine(smi, kernels, conv4d_plain, band_plain):
    """Coarse-to-fine refinement at the PF-Pascal config (400 px, factor
    REFINE_PF = 5 on the 25-cell grid, coarse band REFINE_TOPK = 16 of 25):
    (a) factor 1, radius 0 equals the K band bit for bit through the
    kernels, dense and streamed; (b) the refined serving ladder
    (`refine_serve`) and its forward's stages (`refine_stage_breakdown`);
    (c) PF-Pascal PCK with ``--refine 5`` on PF_PAIRS generated pairs
    (centred features), every pair's readout against the plain band
    layer's up to ties, beside the dense eval; (d) the band
    kernels on the coarse bands of serving (float32, 4 pairs) and of
    training (bfloat16, 16 pairs, with dx and dw) against their plain
    versions; (e) 3 refined bfloat16 training steps at batch 16; (f) the
    InLoc dump with ``--k_size 1 --refine 2``. Stage seconds and peak
    memory for each. Returns the launches of each path."""
    from ncnet_tpu_torch.data.loader import collate
    from ncnet_tpu_torch.eval import pf_pascal
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, immatchnet_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    model, config = build_model()
    stages, problems = {}, []

    # (a) the anchor
    t0 = time.perf_counter()
    batch = synthetic_batch(2, SEED + 61)
    anchor = {}
    with torch.inference_mode():
        for impl in ("dense", "stream"):
            c = config.replace(corr_impl=impl)
            ref = immatchnet_apply(model, c.replace(refine_factor=1,
                                                    refine_topk=BAND_K),
                                   batch["source_image"], batch["target_image"])
            band = immatchnet_apply(model, c.replace(nc_topk=BAND_K),
                                    batch["source_image"], batch["target_image"])
            anchor[impl] = bool(torch.equal(ref, band))
    if not all(anchor.values()):
        problems.append(f"factor 1, radius 0 is not the band bitwise: {anchor}")
    stages["anchor_s"] = time.perf_counter() - t0

    # (b) serving
    t0 = time.perf_counter()
    serve = refine_serve(model, config, kernels)
    problems += serve.pop("problems")
    serve["stages_ms"] = refine_stage_breakdown(
        model, config.replace(refine_factor=REFINE_PF, refine_topk=REFINE_TOPK),
        synthetic_batch(MAX_BATCH, SEED + 65))
    stages["serve_s"] = time.perf_counter() - t0
    serve_launches = serve["pinned_launches"]

    # (c) PF-Pascal eval with --refine 5, beside the dense eval
    t0 = time.perf_counter()
    pf_cfg = config.replace(center_features=True)
    ref_cfg = pf_cfg.replace(refine_factor=REFINE_PF, refine_topk=REFINE_TOPK)
    pf_model = ImMatchNet(pf_cfg, device="cuda",
                          generator=torch.Generator().manual_seed(SEED))
    samples = pf_pascal_pairs(PF_PAIRS, SEED + 7)
    batches = [collate(samples[i:i + MAX_BATCH]) for i in range(0, PF_PAIRS, MAX_BATCH)]
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    res_r = pf_pascal.evaluate(pf_model, ref_cfg, batches, verbose=False)
    refine_eval_s = time.perf_counter() - t1
    eval_peak = torch.cuda.max_memory_allocated()
    res_d = pf_pascal.evaluate(pf_model, pf_cfg, batches, verbose=False)
    eval_launches = {n: k.launches for n, k in kernels.items()}
    nc = pf_model.neigh_consensus
    layer = nc.band_layer
    nc.band_layer = band_plain
    try:
        res_p = pf_pascal.evaluate(pf_model, ref_cfg, batches, verbose=False)
    finally:
        nc.band_layer = layer
    agree, identical = pair_readouts(pf_model, ref_cfg, batches, "band_layer",
                                     band_plain)
    pf_problems, differ = pck_readout_problems(
        f"--refine {REFINE_PF}", [res_p["per_pair"], res_r["per_pair"]], agree,
        identical)
    problems += pf_problems
    n_batches = len(batches)
    if eval_launches["band_gemm_fwd"] != 6 * n_batches or \
            eval_launches["conv4d_fwd"] != 3 * n_batches:
        problems.append(f"refined + dense eval launches {eval_launches}")
    if not (res_r["n_valid"] == PF_PAIRS and all(np.isfinite(res_r["per_pair"]))):
        problems.append("refined PCK not valid for every pair")
    pf_rec = {"refine": REFINE_PF, "refine_topk": REFINE_TOPK, "pairs": PF_PAIRS,
              "pck": res_r["pck"], "pck_dense": res_d["pck"],
              "per_pair": res_r["per_pair"], "per_pair_plain": res_p["per_pair"],
              "per_pair_dense": res_d["per_pair"], "readout_agrees": agree,
              "readout_identical": identical, "pck_differing_pairs": differ,
              "refine_eval_s": refine_eval_s,
              "ms_per_batch": 1e3 * refine_eval_s / n_batches,
              "peak_memory_bytes": eval_peak, "launches": eval_launches}
    del pf_model
    stages["pf_pascal_s"] = time.perf_counter() - t0

    # (d) the band kernels on the refined paths' coarse bands
    t0 = time.perf_counter()
    serve_cfg = config.replace(refine_factor=REFINE_PF, refine_topk=REFINE_TOPK)
    train_cfg = serve_cfg.replace(half_precision=True)
    coarse = {"serve": coarse_band_kernels(
                  model, serve_cfg, synthetic_batch(MAX_BATCH, SEED + 62), kernels,
                  grads=False, path="refine_serve"),
              "train": coarse_band_kernels(
                  model, train_cfg, synthetic_batch(TRAIN_BATCH, SEED + 63), kernels,
                  grads=True, path="refine_train")}
    stages["coarse_band_kernels_s"] = time.perf_counter() - t0

    # (e) refined training, 3 bfloat16 steps
    t0 = time.perf_counter()
    batches = [synthetic_batch(TRAIN_BATCH, SEED + 64 + i) for i in range(TRAIN_STEPS)]
    train = run_steps(model, train_cfg, batches, kernels)
    del batches
    want = {n: 0 for n in kernels}
    want.update(band_gemm_fwd=12, band_gemm_dx=8, band_gemm_dw=12)
    if any(p != want for p in train["launches_per_step"]):
        problems.append(f"refined training launches {train['launches_per_step']}")
    if not all(np.isfinite(train["losses"])):
        problems.append(f"refined training losses {train['losses']}")
    if not all(m > 0 for m in train["moved"][:-1]):
        problems.append(f"refined training: NC tensors did not move {train['moved']}")
    stages["train_s"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()

    # (f) InLoc
    t0 = time.perf_counter()
    inloc_rec = refine_inloc(kernels)
    problems += inloc_rec.pop("problems")
    stages["inloc_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    emit({"phase": "refine", "card": smi, "anchor_bitwise": anchor,
          "serve": serve, "pf_pascal": pf_rec, "train": train,
          "train_config": train_cfg.to_dict(), "inloc": inloc_rec,
          "coarse_band_kernels": coarse, "stages_s": stages})
    if problems:
        raise AssertionError("; ".join(problems))
    return {"launches": {"refine_serve": serve_launches, "refine_eval": eval_launches,
                         "refine_train": train["launches"],
                         "refine_inloc": inloc_rec["launches"]},
            "layers": coarse}


# -- this slice: a trained checkpoint served (C5), pretrained trunk weights
# (A6b), the frozen-trunk feature cache (A11) -------------------------------


def torchvision_resnet101(seed):
    """A torchvision-keyed ResNet-101 state dict (``conv1`` .. ``layer4``,
    ``fc``, ``num_batches_tracked``) of random values from ``seed``: no
    pretrained file can be fetched here. Conv weights at He-like scale and
    BN near the identity keep 30 random blocks' activations finite."""
    from ncnet_tpu_torch.models.resnet import EXPANSION, RESNET101_STAGES

    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = torch.randn(cout, cin, k, k, generator=g) * (
            1.0 / (cin * k * k)) ** 0.5

    def bn(name, c):
        sd[name + ".weight"] = 0.5 + 0.5 * torch.rand(c, generator=g)
        sd[name + ".bias"] = 0.1 * torch.randn(c, generator=g)
        sd[name + ".running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[name + ".running_var"] = torch.rand(c, generator=g) + 0.5
        sd[name + ".num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for si, (n_blocks, planes, _) in enumerate(RESNET101_STAGES + ((3, 512, 2),)):
        for bi in range(n_blocks):
            p = f"layer{si + 1}.{bi}."
            conv(p + "conv1", planes, cin, 1)
            bn(p + "bn1", planes)
            conv(p + "conv2", planes, planes, 3)
            bn(p + "bn2", planes)
            conv(p + "conv3", planes * EXPANSION, planes, 1)
            bn(p + "bn3", planes * EXPANSION)
            if bi == 0:
                conv(p + "downsample.0", planes * EXPANSION, cin, 1)
                bn(p + "downsample.1", planes * EXPANSION)
            cin = planes * EXPANSION
    sd["fc.weight"] = 0.01 * torch.randn(1000, 2048, generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def same_tree(a, b):
    """Two param trees (nested dicts and lists of arrays) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def served_vs_lone(results, lone, tol):
    """Served matches against lone ``[5, n]`` references: the share of rows
    whose picks differ and the largest score gap relative to the
    reference's scale. Each row is one cell's best match, so a pick that
    moved to a (near-)tie keeps its score within ``tol``."""
    differ, err = 0, 0.0
    for got, want in zip(results, lone):
        got = got["matches"]
        differ += int((got[:4] != want[:4]).any(axis=0).sum())
        err = max(err, float(np.abs(got[4] - want[4]).max()
                             / np.abs(want[4]).max()))
    rows = sum(w.shape[1] for w in lone)
    return {"rows": rows, "rows_differing": differ, "score_max_rel_err": err,
            "tol_rel": tol, "ok": bool(err <= tol)}


def phase_checkpoint(smi, kernels):
    """Pretrained trunk weights in training and a trained checkpoint served
    (A6b, C5): a torchvision-keyed ResNet-101 ``.pth`` (random values, with
    its ``layer4`` and ``fc``) saved with ``torch.save``; 2 steps at batch
    16 from it through the train CLI's ``main`` with ``--fe_weights`` (the
    counts set to 0 just before), whose ``.npz`` must hold that trunk
    bitwise; then CKPT_SERVE_REQUESTS requests from that ``.npz`` through
    the serve CLI's ``main`` with ``--checkpoint``, one a batch, against
    `make_match_fn` on `convert.load_model`'s model (up to ties), and again
    at ``--max-batch`` MAX_BATCH for the served pairs/s. Returns the
    launches by path."""
    import io

    from ncnet_tpu_torch.convert import load_model, load_trunk_weights
    from ncnet_tpu_torch.data.images import normalize_image_np, resize_bilinear_np
    from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig
    from ncnet_tpu_torch.serve.__main__ import main as serve_main
    from ncnet_tpu_torch.serve.__main__ import synthetic_pairs
    from ncnet_tpu_torch.serve.buckets import BucketSpec
    from ncnet_tpu_torch.serve.step import make_match_fn
    from ncnet_tpu_torch.train.__main__ import main as train_main
    from ncnet_tpu_torch.train.checkpoint import load_checkpoint

    problems = []
    with tempfile.TemporaryDirectory() as root:
        pth = os.path.join(root, "resnet101.pth")
        torch.save(torchvision_resnet101(SEED), pth)
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train = train_main([
                "--synthetic", "--fe_weights", pth, "--max-steps", "2",
                "--image_size", str(SQUARE_HW[0]),
                "--batch_size", str(TRAIN_BATCH), "--synthetic_pairs",
                str(2 * TRAIN_BATCH), "--num_workers", "4",
                "--result_model_dir", os.path.join(root, "run")])
        train_s = time.perf_counter() - t0
        train_launches = {n: k.launches for n, k in kernels.items()}
        ck = load_checkpoint(train["checkpoint"])
        trunk_ok = same_tree(ck.params["feature_extraction"],
                             load_trunk_weights(pth, "resnet101"))
        want = {n: 0 for n in kernels}
        want.update(conv4d_fwd=12, conv4d_dx=8, conv4d_dw=12)
        if train_launches != want or train["steps"] != 2:
            problems.append(f"--fe_weights training launches {train_launches} != {want}")
        if not (trunk_ok and all(np.isfinite(train["step_losses"]))):
            problems.append("the trained checkpoint's trunk is not the --fe_weights "
                            f"trunk, or a loss is not finite: {train['step_losses']}")

        argv = ["--synthetic", str(CKPT_SERVE_REQUESTS), "--checkpoint",
                train["checkpoint"], "--concurrency", "1", "--image-size",
                str(SQUARE_HW[0])]
        results = []
        for k in kernels.values():
            k.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            lone_run = serve_main(argv + ["--max-batch", "1"], results=results)
        serve_launches = {n: k.launches for n, k in kernels.items()}
        with contextlib.redirect_stdout(io.StringIO()):
            batched = serve_main(argv + ["--max-batch", str(MAX_BATCH)])
        config = ImMatchNetConfig.from_dict(lone_run["config"])
        _, model = load_model(train["checkpoint"], device="cuda")
        fn = make_match_fn(config)
        spec = BucketSpec(SQUARE_HW[0])
        lone = []
        for pair in synthetic_pairs(CKPT_SERVE_REQUESTS, 0):
            src, tgt = (torch.from_numpy(normalize_image_np(resize_bilinear_np(
                img, *spec.bucket(*img.shape[:2]))).astype(np.float32))[None].cuda()
                for img in pair)
            with torch.inference_mode():
                lone.append(fn(model, src, tgt)[:, 0].cpu().numpy())
        del model
    # bfloat16 (the checkpoint's dtype): a pick moved to a near tie keeps
    # its score within a bfloat16 step of the scale
    agree = served_vs_lone(results, lone, BAND_TOL[torch.bfloat16])
    # warmup: both buckets once; then 3 launches a square pair, 6 a
    # rectangular one (every fourth target is 304x400)
    n_rect = CKPT_SERVE_REQUESTS // 4
    serve_want = 3 * (CKPT_SERVE_REQUESTS - n_rect + 1) + 6 * (n_rect + 1)
    if serve_launches["conv4d_fwd"] != serve_want or lone_run["failed"]:
        problems.append(f"served launches {serve_launches} (want {serve_want} "
                        f"conv4d_fwd) or failures {lone_run['failed']}")
    if not agree["ok"] or lone_run["weights"] != train["checkpoint"]:
        problems.append(f"served matches disagree with make_match_fn: {agree}")
    emit({"phase": "checkpoint", "card": smi, "fe_weights": "torchvision-keyed "
          "ResNet-101 state dict (random values from the seed, layer4 and fc "
          "included)", "train": {k: train[k] for k in (
              "weights", "steps", "step_losses", "step_ms", "peak_memory_bytes")},
          "train_s": train_s, "train_launches": train_launches,
          "trunk_is_the_fe_weights": trunk_ok,
          "serve": {"weights": lone_run["weights"], "config": lone_run["config"],
                    "requests": CKPT_SERVE_REQUESTS, "launches": serve_launches,
                    "pairs_per_s_batch1": lone_run["pairs_per_s"],
                    "pairs_per_s": batched["pairs_per_s"],
                    "max_batch": MAX_BATCH,
                    "latency_p50_ms": batched["latency_p50_ms"],
                    "vs_make_match_fn": agree}})
    if problems:
        raise AssertionError("; ".join(problems))
    return {"checkpoint_train": train_launches, "checkpoint_serve": serve_launches}


def band_swaps_explained(corr, corr_other, idx_1, idx_2):
    """`band_index_swaps` with the mutual selection's cascade allowed for:
    a near tie in a B column flips two entries' column ranks, and the row
    of an entry that entered or left its band then gives up or takes
    another entry that is no tie itself. So every A row whose index set
    differs must hold a swapped entry that is a near tie (within twice the
    two correlations' largest difference of another entry of its row or
    column)."""
    b, ha, wa, hb, wb = corr.shape
    na, nb = ha * wa, hb * wb
    c = corr.reshape(b, na, nb).float()
    delta = float((c - corr_other.reshape(b, na, nb).float()).abs().max())

    def member(idx):
        m = torch.zeros((b, na, nb), dtype=torch.bool, device=c.device)
        return m.scatter_(2, idx.reshape(b, na, -1).long(), True)

    diff = member(idx_1) ^ member(idx_2)
    near = torch.zeros_like(diff)
    where = diff.nonzero()
    if len(where):
        bi, a, j = where.unbind(1)
        v = c[bi, a, j][:, None]
        row, col = (c[bi, a] - v).abs(), (c[bi, :, j] - v).abs()
        n = torch.arange(len(where), device=c.device)
        row[n, j] = col[n, a] = float("inf")
        near[bi, a, j] = torch.minimum(row.amin(1), col.amin(1)) <= 2 * delta
    rows = diff.any(-1)
    return {"rows": int(rows.sum()), "rows_with_a_near_tie": int(near.any(-1).sum()),
            "entries": int(diff.sum()), "near_ties": int(near.sum()), "delta": delta}


def store_megabytes(root):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(root)
               for f in files) / 1e6


def phase_feature_cache(smi, kernels):
    """Training from cached trunk features (A11) at the PF-Pascal config,
    bfloat16: `train.__main__.open_feature_cache` populates ``train``
    (CACHE_TRAIN_PAIRS pairs) and ``val`` (CACHE_VAL_PAIRS) stores at 400
    px (a ResNet-101 forward of 16 images a call), timed, and their size;
    3 cached steps at batch 16 (`FeatureBatchLoader`, the counts set to 0
    just before) dense, on the K = 50 band (dense selection), streamed,
    and dense again pinned on the card: no trunk call in a cached step,
    6 / 4 / 6 conv4d or 12 / 8 / 12 band launches a step, the pinned losses
    bitwise the unpinned ones, each loss within CACHE_LOSS_TOL of the image
    path's on the same batches and weights; the stage times of a dense and
    a band step, cached and from images; one cached eval step on ``val``;
    the stores re-opened under another trunk must raise
    `FeatureCacheMismatch`. Returns the launches by path."""
    from ncnet_tpu_torch.data.features_loader import FeatureBatchLoader
    from ncnet_tpu_torch.data.loader import collate
    from ncnet_tpu_torch.data.pairs import SyntheticPairDataset
    from ncnet_tpu_torch.features import FeatureCacheMismatch
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet
    from ncnet_tpu_torch.train.__main__ import open_feature_cache
    from ncnet_tpu_torch.train.step import (
        create_train_state,
        device_batch,
        make_eval_step,
    )

    model, config = build_model()
    config = config.replace(half_precision=True)
    datasets = {"train": SyntheticPairDataset(n=CACHE_TRAIN_PAIRS,
                                              output_size=SQUARE_HW, seed=SEED + 70),
                "val": SyntheticPairDataset(n=CACHE_VAL_PAIRS, output_size=SQUARE_HW,
                                            seed=SEED + 71)}
    trunk_calls = []
    hook = model.feature_extraction.register_forward_hook(
        lambda *a: trunk_calls.append(1))
    problems, runs, stages = [], {}, {}
    nc0 = [t.detach().clone() for t in model.neigh_consensus.trainable()]

    def reset_nc():
        with torch.no_grad():
            for t, t0 in zip(model.neigh_consensus.trainable(), nc0):
                t.copy_(t0)

    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        populate = {}
        stores = open_feature_cache(root, model, config, SQUARE_HW, datasets, populate)
        torch.cuda.synchronize()
        populate_s = time.perf_counter() - t0
        shards = sum(f.endswith(".feat") for _, _, fs in os.walk(root) for f in fs)
        store_mb = store_megabytes(root)
        extract_calls = len(trunk_calls)
        if shards != 2 * (CACHE_TRAIN_PAIRS + CACHE_VAL_PAIRS):
            problems.append(f"{shards} shards written")
        other = ImMatchNet(config, device="cuda",
                           generator=torch.Generator().manual_seed(SEED + 1))
        mismatch = None
        try:
            open_feature_cache(root, other, config, SQUARE_HW, datasets)
            problems.append("stores re-opened under another trunk did not raise")
        except FeatureCacheMismatch as e:
            mismatch = str(e)[:120]
        del other
        torch.cuda.empty_cache()

        modes = (("dense", config, False),
                 ("band", config.replace(nc_topk=TRAIN_K), False),
                 ("stream", config.replace(nc_topk=TRAIN_K, corr_impl="stream"), False),
                 ("dense_pinned", config, True))
        for name, cfg, pin in modes:
            with FeatureBatchLoader(stores["train"], TRAIN_BATCH, shuffle=True,
                                    seed=SEED, num_workers=4, drop_last=True,
                                    pin_hbm=pin, device="cuda") as loader:
                feats = [b for e in (0, 1) for b in loader.iter_epoch(e)][:TRAIN_STEPS]
                plan = [i for e in (0, 1)
                        for i in loader._dl._epoch_batches(e)][:TRAIN_STEPS]
                feats = [device_batch(b, "cuda") for b in feats]
                reset_nc()
                trunk_calls.clear()
                runs[name] = run_steps(model, cfg, feats, kernels, from_features=True)
                runs[name]["trunk_calls"] = len(trunk_calls)
            if pin:
                runs[name]["pinned_mbytes"] = loader.pinned_nbytes() / 1e6
                continue
            images = [device_batch(collate([datasets["train"][int(i)] for i in idx]),
                                   "cuda") for idx in plan]
            reset_nc()
            runs[name]["image_path"] = run_steps(model, cfg, images, kernels)
            if name != "stream":
                breakdown = (train_stage_breakdown if name == "dense"
                             else band_train_stage_breakdown)
                for label, batch in (("cached", feats[0]), ("images", images[0])):
                    opt = create_train_state(model, 5e-4).optimizer
                    breakdown(model, cfg, batch, opt)  # warm
                    stages[f"{name}_{label}"] = breakdown(model, cfg, batch, opt)
                    reset_nc()
            del images, feats
        val_feats = next(iter(FeatureBatchLoader(stores["val"], TRAIN_BATCH,
                                                 num_workers=2).iter_epoch(0)))
        val_loss = float(make_eval_step(config, from_features=True)(model, val_feats))
    hook.remove()
    reset_nc()
    del model
    torch.cuda.empty_cache()

    dense_want = {n: 0 for n in kernels}
    dense_want.update(conv4d_fwd=6, conv4d_dx=4, conv4d_dw=6)
    band_want = {n: 0 for n in kernels}
    band_want.update(band_gemm_fwd=12, band_gemm_dx=8, band_gemm_dw=12)
    gaps = {}
    for name, run in runs.items():
        want = band_want if name in ("band", "stream") else dense_want
        if any(p != want for p in run["launches_per_step"]):
            problems.append(f"{name}: launches a step {run['launches_per_step']} != {want}")
        if run["trunk_calls"]:
            problems.append(f"{name}: the trunk ran {run['trunk_calls']} times in "
                            "cached steps")
        if not all(np.isfinite(run["losses"])):
            problems.append(f"{name}: a loss is not finite: {run['losses']}")
        if "image_path" in run:
            gaps[name] = [abs(a - b) for a, b in
                          zip(run["losses"], run["image_path"]["losses"])]
            if not all(g <= CACHE_LOSS_TOL for g in gaps[name]):
                problems.append(f"{name}: cached vs image-path losses differ by "
                                f"{gaps[name]}")
    if runs["dense_pinned"]["losses"] != runs["dense"]["losses"]:
        problems.append("pinned losses are not bitwise the unpinned ones: "
                        f"{runs['dense_pinned']['losses']} vs {runs['dense']['losses']}")
    if not np.isfinite(val_loss):
        problems.append(f"cached eval loss {val_loss}")
    emit({"phase": "feature_cache", "card": smi, "config": config.to_dict(),
          "pairs": {"train": CACHE_TRAIN_PAIRS, "val": CACHE_VAL_PAIRS},
          "populate": populate, "populate_s": populate_s,
          "trunk_calls_to_populate": extract_calls, "shards": shards,
          "store_mbytes": store_mb, "shard_mbytes": store_mb / max(shards, 1),
          "mismatch_raised": mismatch, "runs": runs, "loss_gaps_vs_image_path": gaps,
          "loss_tol": CACHE_LOSS_TOL, "stages_ms": stages, "val_loss": val_loss})
    if problems:
        raise AssertionError("; ".join(problems))

    def total(names):
        return {n: sum(runs[m]["launches"][n] for m in names) for n in kernels}

    return {"feature_cache": total(("dense", "dense_pinned")),
            "feature_cache_band": total(("band", "stream"))}


def phase_feature_store_serve(smi, model, config, kernels):
    """Serving from a gallery feature store (A11): 2 x STORE_IMAGES requests
    over STORE_IMAGES generated images (6 at 400x400, 2 at 304x400), each
    pinned to the standard (dense) and to the degraded (K = BAND_K band)
    program of a ServeEngine whose prep is the serve CLI's
    (`feature_store_prep`), twice: the first pass extracts each image once
    (the trunk runs STORE_IMAGES times), the second reads every image from
    the store (no trunk call). Both passes' matches against the image
    path's engine on the same requests, float32 (TF32 off); the image path
    runs one request a batch, so its trunk sees each image at batch 1 as
    the store's extraction does. The standard rung's served matches must
    equal the image path's up to ties. A band's selection depends on the
    last bits of the correlation (cuBLAS may sum it in another order for
    another batch's composition, and the store's features may differ from
    the image path's in the last bits), and a candidate swapped at the
    band's edge moves its neighbours' NC output: so the degraded rung is
    held by its bands, each request's band from the store's features
    against the band from the image path's, every A row whose band differs
    holding a near tie (`band_swaps_explained`), and the image engine's degraded rows against
    the degraded program at one request a batch; the store's degraded rows
    against the image path's are reported. Every served result is finite
    and of its shape. The launches of the two store passes (counts set to
    0 just before). Returns them."""
    from ncnet_tpu_torch import bridge
    from ncnet_tpu_torch.data.images import normalize_image_np, resize_bilinear_np
    from ncnet_tpu_torch.features import GalleryFeatureStore, trunk_digest
    from ncnet_tpu_torch.serve.__main__ import feature_store_prep
    from ncnet_tpu_torch.serve.buckets import BucketSpec
    from ncnet_tpu_torch.serve.engine import ServeEngine
    from ncnet_tpu_torch.serve.step import make_serve_match_step

    rng = np.random.RandomState(SEED + 80)
    images = {f"img{i}": rng.uniform(0, 255, (RECT_HW if i >= 6 else SQUARE_HW)
                                     + (3,)).astype(np.float32)
              for i in range(STORE_IMAGES)}
    keys = sorted(images)
    requests = [((keys[i], images[keys[i]]), (keys[(i + s) % STORE_IMAGES],
                                               images[keys[(i + s) % STORE_IMAGES]]))
                for s in (1, 3) for i in range(STORE_IMAGES)]
    spec = BucketSpec(SQUARE_HW[0])

    def resized(img):
        h, w = spec.bucket(img.shape[0], img.shape[1])
        return normalize_image_np(resize_bilinear_np(img, h, w)).astype(np.float32)

    def image_prep(pair):
        src, tgt = (resized(img) for _, img in pair)
        return (src.shape[:2], tgt.shape[:2]), {"source_image": src,
                                                "target_image": tgt}

    served = []

    def counted(variant, from_features):
        cfg = config.replace(nc_topk=BAND_K) if variant == "degraded" else config
        apply = make_serve_match_step(cfg, from_features=from_features)

        def run(m, batch):
            served.append((variant, tuple(batch["source_image"].shape[1:3]),
                           tuple(batch["target_image"].shape[1:3])))
            return apply(m, batch)

        return run

    def serve_pass(engine):
        futures = {}
        lock = threading.Lock()

        def client(idx):
            for i in idx:
                for v in ("standard", "degraded"):
                    f = engine.submit(requests[i], variant=v)
                    with lock:
                        futures[i, v] = f

        threads = [threading.Thread(target=client, args=(range(c, len(requests), 4),))
                   for c in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out = {k: f.result(timeout=600) for k, f in futures.items()}
        return out, time.perf_counter() - t0

    def engine_for(prep, from_features, max_batch=MAX_BATCH):
        return ServeEngine(counted("standard", from_features), model, device="cuda",
                           max_batch=max_batch, max_wait=0.05, prep_fn=prep,
                           degraded_apply_fn=counted("degraded", from_features))

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    fdim = 1024  # ResNet-101 to layer3
    grids = {hw: (hw[0] // 16, hw[1] // 16) for hw in (SQUARE_HW, RECT_HW)}
    warm_specs = [((grids[SQUARE_HW], grids[hw]), {
        "source_image": (grids[SQUARE_HW] + (fdim,), torch.float32),
        "target_image": (grids[hw] + (fdim,), torch.float32)})
        for hw in (SQUARE_HW, RECT_HW)]
    trunk_calls = []
    hook = model.feature_extraction.register_forward_hook(
        lambda *a: trunk_calls.append(1))
    passes, problems = [], []
    with tempfile.TemporaryDirectory() as root:
        store = GalleryFeatureStore.open_or_create(
            root, trunk_digest(bridge.to_jax_params(model)["feature_extraction"],
                               config, None), config)
        with engine_for(feature_store_prep(store, model, config, resized),
                        True) as engine:
            engine.warmup(warm_specs)
            for k in kernels.values():
                k.launches = 0
            served.clear()
            for label in ("cold", "warm"):
                trunk_calls.clear()
                results, secs = serve_pass(engine)
                passes.append({"label": label, "results": results, "seconds": secs,
                               "trunk_calls": len(trunk_calls),
                               "pairs_per_s": 2 * len(requests) / secs})
            launches = {n: k.launches for n, k in kernels.items()}
            store_served = list(served)
        store_mb = store_megabytes(root)
        store_features = {k: store.get(k)[0] for k in keys}
    hook.remove()
    with engine_for(image_prep, False, max_batch=1) as engine:
        engine.warmup([((SQUARE_HW, hw), {
            "source_image": (SQUARE_HW + (3,), np.dtype(np.float32)),
            "target_image": (hw + (3,), np.dtype(np.float32))})
            for hw in (SQUARE_HW, RECT_HW)])
        t0 = time.perf_counter()
        image_results, image_s = serve_pass(engine)
    # the degraded rung: each request's band from the store's features
    # against the band from the image path's trunk at batch 1 (the image
    # engine's features), and the degraded program on both
    from ncnet_tpu_torch.models.immatchnet import extract_features
    from ncnet_tpu_torch.ops.band import topk_band
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import mutual_matching

    deg_cfg = config.replace(nc_topk=BAND_K)
    degraded = make_serve_match_step(deg_cfg, from_features=True)
    swaps, lone, lone_image, feat_err = [], [], [], 0.0
    with torch.inference_mode():
        image_feats = {k: extract_features(model, config, torch.from_numpy(
            resized(images[k]))[None].cuda())[0] for k in keys}
        feats = {k: store_features[k].cuda() for k in keys}
        for k in keys:
            feat_err = max(feat_err, float((feats[k] - image_feats[k]).abs().max()
                                           / image_feats[k].abs().max()))
        for (ka, _), (kb, _) in requests:
            sel = []
            for fs in (feats, image_feats):
                corr = correlation_4d(fs[ka][None], fs[kb][None])
                _, idx = topk_band(corr, BAND_K, values_from=mutual_matching(corr),
                                   mutual=deg_cfg.nc_topk_mutual)
                sel.append((corr, idx))
            swaps.append(band_swaps_explained(sel[0][0], sel[1][0], sel[0][1],
                                              sel[1][1]))
            for fs, out in ((feats, lone), (image_feats, lone_image)):
                out.append(degraded(model, {"source_image": fs[ka][None],
                                            "target_image": fs[kb][None]}
                                    )["matches"][0].cpu().numpy())
    swapped = {k: sum(w[k] for w in swaps)
               for k in ("rows", "rows_with_a_near_tie", "entries", "near_ties")}
    swapped["max_delta"] = max(w["delta"] for w in swaps)
    order = {v: [(i, v) for i in range(len(requests))]
             for v in ("standard", "degraded")}
    agree = {"degraded_band_swaps": dict(swapped, ok=swapped["rows_with_a_near_tie"]
                                         == swapped["rows"]),
             "features_max_rel_diff": feat_err,
             "degraded_one_a_batch": served_vs_lone(
                 [{"matches": m} for m in lone],
                 [image_results[k]["matches"] for k in order["degraded"]], SERVE_TOL),
             "degraded_image_engine_vs_one_a_batch": served_vs_lone(
                 [image_results[k] for k in order["degraded"]], lone_image, SERVE_TOL)}
    served_degraded = {}
    for p in passes:
        agree[f"{p['label']}_standard"] = served_vs_lone(
            [p["results"][k] for k in order["standard"]],
            [image_results[k]["matches"] for k in order["standard"]], SERVE_TOL)
        served_degraded[p["label"]] = served_vs_lone(
            [p["results"][k] for k in order["degraded"]], lone, SERVE_TOL)
        check_matches([(a[1].shape[:2], b[1].shape[:2]) for a, b in requests] * 2,
                      [p["results"][k] for v in order.values() for k in v])
    for p in passes:
        del p["results"]
    want = {n: 0 for n in kernels}
    # a pair of one grid runs the symmetric NC net once, two grids twice
    want["conv4d_fwd"] = sum(3 if a == t else 6 for v, a, t in store_served
                             if v == "standard")
    want["band_gemm_fwd"] = 6 * sum(v == "degraded" for v, _, _ in store_served)
    if launches != want:
        problems.append(f"store passes' launches {launches} != {want}")
    if [p["trunk_calls"] for p in passes] != [STORE_IMAGES, 0]:
        problems.append(f"trunk calls (cold, warm) {[p['trunk_calls'] for p in passes]}"
                        f" != [{STORE_IMAGES}, 0]")
    # gated: the standard rung's matches up to ties; the degraded rung's
    # band swaps all near ties, and the image engine's degraded rows its
    # program's at one request a batch; the rest is reported
    gated = ("cold_standard", "warm_standard", "degraded_band_swaps",
             "degraded_image_engine_vs_one_a_batch")
    if not all(agree[g]["ok"] for g in gated):
        problems.append(f"store matches disagree with the image path: {agree}")
    emit({"phase": "feature_store_serve", "card": smi, "config": config.to_dict(),
          "degraded_topk": BAND_K, "images": STORE_IMAGES, "requests": len(requests),
          "passes": passes, "image_path_pairs_per_s": 2 * len(requests) / image_s,
          "store_mbytes": store_mb, "launches": launches, "vs_image_path": agree,
          "served_degraded_vs_one_a_batch": served_degraded})
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def kernel_line(name, source, replaces, launches, layers, work, smi,
                launches_by_path=None):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": launches_by_path,
        "max_abs_err": max(layer["max_abs_err"] for layer in layers),
        # relative to the reference's scale where the timed run checks it
        "max_rel_err": (max(layer["max_rel_err"] for layer in layers)
                        if all("max_rel_err" in layer for layer in layers)
                        else None),
        "ms": sum(layer["ms"] for layer in layers),
        "plain_ms": sum(layer["plain_ms"] for layer in layers),
        "bound_ms": sum(layer["bound_ms"] for layer in layers),
        "bound_by": max(layers, key=lambda la: la["bound_ms"])["bound_by"],
        "library_ms": None,
        "work": work,
        "card": smi,
        "layers": layers,
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs a card")
    # the port itself: this fails where chip_smoke.py stands without it
    from ncnet_tpu_torch.kernels.band_gemm import band_gemm_dx, band_gemm_fwd
    from ncnet_tpu_torch.kernels.band_gemm_dw import band_gemm_dw
    from ncnet_tpu_torch.kernels.conv4d import conv4d_dx, conv4d_fwd
    from ncnet_tpu_torch.kernels.conv4d_dw import conv4d_dw
    from ncnet_tpu_torch.ops.band import band_layer_plain
    from ncnet_tpu_torch.ops.conv4d import (
        conv4d_dw_plain,
        conv4d_dx_plain,
        conv4d_plain,
    )

    kernels = {"conv4d_fwd": conv4d_fwd, "conv4d_dx": conv4d_dx,
               "conv4d_dw": conv4d_dw, "band_gemm_fwd": band_gemm_fwd,
               "band_gemm_dx": band_gemm_dx, "band_gemm_dw": band_gemm_dw}
    smi = phase_device()
    # conv4d_dx launches conv4d_fwd's library: five builds
    phase_build({"conv4d_fwd": conv4d_fwd, "band_gemm_fwd": band_gemm_fwd,
                 "conv4d_dw": conv4d_dw, "band_gemm_dw": band_gemm_dw,
                 "band_gemm_dx": band_gemm_dx})
    layers = phase_kernels(smi, conv4d_fwd, conv4d_plain)
    fwd_train_layers, dx_layers, dw_layers = phase_train_kernels(
        smi, kernels, conv4d_plain, conv4d_dx_plain, conv4d_dw_plain)
    synth_layers = phase_synthetic_kernels(
        smi, kernels, conv4d_plain, conv4d_dx_plain, conv4d_dw_plain)
    band_layers = phase_band_kernels(smi, band_gemm_fwd, band_layer_plain)
    model, config = build_model()
    band_train_layers = phase_band_train_kernels(smi, model, config, kernels)
    launches = phase_serve(smi, model, config, conv4d_fwd, conv4d_plain)
    band_launches = phase_serve_band(smi, model, config, conv4d_fwd,
                                     band_gemm_fwd, band_layer_plain)
    phase_full_k(smi, model, config, conv4d_fwd, band_gemm_fwd)
    # the dw launches of the train and eval paths by dtype (float32: the
    # gradient check, the float32 stage breakdown, the synthetic float32 run)
    dw_dtypes = [dict(conv4d_dw.launches_by_dtype)]
    train_launches = phase_train(smi, model, config, kernels, conv4d_plain)
    dw_dtypes.append(dict(conv4d_dw.launches_by_dtype))
    band_train_launches = phase_train_band(smi, model, config, kernels)
    dw_dtypes.append(dict(conv4d_dw.launches_by_dtype))
    eval_launches = phase_eval(smi, config, kernels, conv4d_plain,
                               band_layer_plain)
    dw_dtypes.append(dict(conv4d_dw.launches_by_dtype))
    dw_by_dtype = {path: {t: after[t] - before[t] for t in after}
                   for path, before, after in (("train", *dw_dtypes[0:2]),
                                               ("eval", *dw_dtypes[2:4]))}
    inloc_launches, inloc_layers_ = phase_inloc(smi, kernels, conv4d_plain)
    ft_launches, ft_dx = phase_finetune(smi, kernels, conv4d_dx_plain, band=False)
    ftb_launches, ftb_dx = phase_finetune(smi, kernels, conv4d_dx_plain, band=True)
    trunk_launches = phase_trunks(smi, kernels, conv4d_plain)
    phase_stream(smi)
    stream_launches = phase_train_stream(smi, config, kernels)
    refine = phase_refine(smi, kernels, conv4d_plain, band_layer_plain)
    refine_launches, coarse = refine["launches"], refine["layers"]
    ckpt_launches = phase_checkpoint(smi, kernels)
    cache_launches = phase_feature_cache(smi, kernels)
    store_serve = phase_feature_store_serve(smi, model, config, kernels)
    # every kernel of the later slices' paths launched where it runs
    dense_grad = ("conv4d_fwd", "conv4d_dx", "conv4d_dw")
    band_grad = ("band_gemm_fwd", "band_gemm_dx", "band_gemm_dw")
    slice_paths = (stream_launches | refine_launches | ckpt_launches | cache_launches
                   | {"feature_store_serve": store_serve,
                      "inloc_store": inloc_launches["store"]})
    for path, names in (("train_stream", band_grad), ("finetune_stream", band_grad),
                        ("refine_serve", ("conv4d_fwd", "band_gemm_fwd")),
                        ("refine_eval", ("conv4d_fwd", "band_gemm_fwd")),
                        ("refine_train", band_grad),
                        ("refine_inloc", ("band_gemm_fwd",)),
                        ("checkpoint_train", dense_grad),
                        ("checkpoint_serve", ("conv4d_fwd",)),
                        ("feature_cache", dense_grad),
                        ("feature_cache_band", band_grad),
                        ("feature_store_serve", ("conv4d_fwd", "band_gemm_fwd")),
                        ("inloc_store", ("conv4d_fwd",))):
        counts = slice_paths[path]
        if not all(counts[n] > 0 for n in names):
            raise AssertionError(f"{path} did not launch {names}: {counts}")

    def band_train_by_path(name):
        return {path: band_train_launches[path][name]
                for path in ("train_band", "synthetic_band")} | {
                    "finetune_band": ftb_launches[name]} | {
                    path: slice_paths[path][name]
                    for path in ("train_stream", "finetune_stream", "refine_train",
                                 "feature_cache_band")}

    fwd_by_path = {"serve": launches, "train": train_launches["conv4d_fwd"],
                   "eval": eval_launches["conv4d_fwd"],
                   "inloc": inloc_launches["host"]["conv4d_fwd"],
                   "inloc_device_route": inloc_launches["device"]["conv4d_fwd"],
                   "finetune": ft_launches["conv4d_fwd"],
                   "trunks": trunk_launches["conv4d_fwd"],
                   "refine_serve": refine_launches["refine_serve"]["conv4d_fwd"],
                   "refine_eval": refine_launches["refine_eval"]["conv4d_fwd"],
                   **{path: slice_paths[path]["conv4d_fwd"] for path in (
                       "checkpoint_train", "checkpoint_serve", "feature_cache",
                       "feature_store_serve", "inloc_store")}}
    band_by_path = {"serve_band": band_launches,
                    "eval": eval_launches["band_gemm_fwd"],
                    **band_train_by_path("band_gemm_fwd"),
                    **{path: refine_launches[path]["band_gemm_fwd"] for path in
                       ("refine_serve", "refine_eval", "refine_inloc")},
                    "feature_store_serve": store_serve["band_gemm_fwd"]}

    def grad_by_path(name):
        return {"train": train_launches[name], "eval": eval_launches[name],
                "finetune": ft_launches[name], "trunks": trunk_launches[name],
                "checkpoint_train": slice_paths["checkpoint_train"][name],
                "feature_cache": slice_paths["feature_cache"][name]}

    emit({"kernels": [
        kernel_line("conv4d_fwd", "ncnet_tpu_torch/csrc/conv4d_fwd.cu",
                    "ncnet_tpu/kernels/conv4d_pallas.py:65",
                    sum(fwd_by_path.values()),
                    [{**la, "path": "serve"} for la in layers]
                    + [{**la, "path": "train"} for la in fwd_train_layers]
                    + synth_layers["fwd"] + inloc_layers_,
                    "the three NC layers of one square serving batch "
                    f"({MAX_BATCH} pairs x 2 directions), float32; of one "
                    f"pipeline call of a training step ({TRAIN_BATCH} pairs x "
                    "2 directions), bfloat16; the two NC layers (3^4) of a "
                    "synthetic convergence call (8 pairs x 2 directions, 8x8 "
                    "grid), float32 and bfloat16; and the two InLoc NC layers "
                    "(3^4, bfloat16) at the pooled grid of a 3200 px pair in "
                    "both directions. Launches: the served batches', "
                    f"{TRAIN_STEPS} training steps', the eval phase's "
                    "(synthetic convergence, PF-Pascal evaluate and "
                    "evaluate_serving), the InLoc dump's, and the later "
                    "slices': the standard rung's batches of the refined "
                    "serving ladder and the dense PF-Pascal eval beside "
                    "--refine; the --fe_weights training steps and the "
                    "serving of their checkpoint; cached training steps "
                    "(unpinned and pinned); the standard program served from "
                    "a gallery store; the InLoc dumps from a gallery store",
                    smi, fwd_by_path),
        kernel_line("band_gemm_fwd", "ncnet_tpu_torch/csrc/band_gemm_fwd.cu",
                    "ncnet_tpu/kernels/band_gemm_pallas.py:83",
                    sum(band_by_path.values()),
                    [{**la, "path": "serve_band"} for la in band_layers]
                    + band_train_layers["fwd"] + coarse["serve"]["fwd"]
                    + coarse["train"]["fwd"],
                    "the three band NC layers x 2 symmetric passes of one "
                    f"square degraded batch ({MAX_BATCH} pairs, K = {BAND_K}),"
                    " float32, of one pipeline call of a band training "
                    f"step ({TRAIN_BATCH} pairs, K = {TRAIN_K}), bfloat16, "
                    "and of the coarse band (400 px pooled by "
                    f"{REFINE_PF}, K = {REFINE_TOPK}) of a refined serving "
                    f"batch ({MAX_BATCH} pairs, float32) and of a refined "
                    f"training call ({TRAIN_BATCH} pairs, bfloat16); "
                    "taps derived from the band's indices, no pointer table. "
                    "Launches: the degraded batches', pck_vs_topk's at "
                    f"K = {BAND_K}, {TRAIN_STEPS} band training steps', "
                    f"the synthetic run's at K = {SYNTH_BAND_K}, and this "
                    "slice's: streamed band training and fine-tuning, the "
                    "refined rung's batches, the refined PF-Pascal eval, "
                    f"{TRAIN_STEPS} refined training steps, the refined "
                    "InLoc dump, cached band training (dense and streamed "
                    "selection) and the degraded program served from a "
                    "gallery store", smi, band_by_path),
        kernel_line("band_gemm_dx", "ncnet_tpu_torch/csrc/band_gemm_dx.cu",
                    "ncnet_tpu/kernels/band_gemm_pallas.py:147",
                    sum(band_train_by_path("band_gemm_dx").values()),
                    band_train_layers["dx"] + ftb_dx + coarse["train"]["dx"],
                    "the input gradients of band NC layers 2 and 3 x 2 "
                    "symmetric passes of one pipeline call of a band training "
                    f"step ({TRAIN_BATCH} pairs, K = {TRAIN_K}), bfloat16, over "
                    "the pass's hit list (which dw builds and shares), and of "
                    "layer 1 (a 16->1 contraction, fine-tuning's) on both "
                    "passes, and of layers 2 and 3 on the coarse band of a "
                    f"refined training call ({TRAIN_BATCH} pairs, K = "
                    f"{REFINE_TOPK}). Launches: {TRAIN_STEPS} band training "
                    f"steps', the synthetic run's at K = {SYNTH_BAND_K}, "
                    f"{FT_BF16_STEPS + FT_F32_STEPS} band fine-tuning steps', "
                    "the streamed band's training and fine-tuning steps', "
                    f"{TRAIN_STEPS} refined training steps' and the cached "
                    "band training steps'", smi,
                    band_train_by_path("band_gemm_dx")),
        kernel_line("band_gemm_dw", "ncnet_tpu_torch/csrc/band_gemm_dw.cu",
                    "ncnet_tpu/kernels/band_gemm_pallas.py:147",
                    sum(band_train_by_path("band_gemm_dw").values()),
                    band_train_layers["dw"] + coarse["train"]["dw"],
                    "the weight gradients of the three band NC layers x 2 "
                    "symmetric passes of one pipeline call of a band training "
                    f"step ({TRAIN_BATCH} pairs, K = {TRAIN_K}), bfloat16, each "
                    "with a third of its pass's hit-list build, and on the "
                    f"coarse band of a refined training call (K = {REFINE_TOPK}). "
                    f"Launches: {TRAIN_STEPS} band training steps', the "
                    f"synthetic run's at K = {SYNTH_BAND_K}, the band "
                    "fine-tuning steps', the streamed band's training and "
                    f"fine-tuning steps', {TRAIN_STEPS} refined training "
                    "steps' and the cached band training steps'", smi,
                    band_train_by_path("band_gemm_dw")),
        kernel_line("conv4d_dx", "ncnet_tpu_torch/csrc/conv4d_fwd.cu",
                    "ncnet_tpu/kernels/conv4d_pallas.py:190",
                    sum(grad_by_path("conv4d_dx").values()),
                    [{**la, "path": "train"} for la in dx_layers] + synth_layers["dx"]
                    + [{**la, "path": "finetune"} for la in ft_dx],
                    "the input gradients of NC layers 2 and 3 of one pipeline "
                    f"call of a training step ({TRAIN_BATCH} pairs x 2 "
                    "directions), bfloat16, of the 16 -> 1 layer (3^4) of "
                    "a synthetic convergence call, float32 and bfloat16, and "
                    "of layer 1 (a 16->1 contraction) at a fine-tuning step's "
                    "pipeline call, bfloat16 and float32; launches over "
                    f"{TRAIN_STEPS} steps, the synthetic convergence runs, "
                    f"{FT_BF16_STEPS + FT_F32_STEPS} fine-tuning steps, the "
                    "trunks phase's steps, the --fe_weights training steps "
                    "and the cached training steps", smi,
                    grad_by_path("conv4d_dx")),
        {**kernel_line(
            "conv4d_dw", "ncnet_tpu_torch/csrc/conv4d_dw.cu",
            "ncnet_tpu/kernels/conv4d_pallas.py:211",
            sum(grad_by_path("conv4d_dw").values()),
            [{**la, "path": "train"} for la in dw_layers] + synth_layers["dw"],
            "the weight gradients of the three NC layers of one pipeline call "
            f"of a training step ({TRAIN_BATCH} pairs x 2 directions), "
            "bfloat16 and float32 (`--no-bf16`), the float32 ones at 2 "
            "samples too, and of the two NC layers (3^4) of a synthetic "
            "convergence call, float32 and bfloat16; launches over "
            f"{TRAIN_STEPS} steps, the synthetic convergence runs and the "
            "later slices' training paths (launches_by_dtype_by_path: the "
            "train phase's float32 ones are "
            "the gradient check's and the float32 stage breakdown's)", smi,
            grad_by_path("conv4d_dw")),
         "launches_by_dtype_by_path": dw_by_dtype},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
