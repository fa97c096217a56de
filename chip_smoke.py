#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (picasso_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
1. environment: torch/CUDA versions, the card's name and power limit;
2. build: the CUDA kernels from picasso_torch/csrc (one nvcc per source,
   sm_90a), with ptxas' registers and spills per kernel instance;
3. kernels against their plain PyTorch versions on the card, at the
   main paths' shapes, on 131,072 spots of tests/torch_data.make_spots
   (box 7): the MLE fit kernel's one-thread pass (csrc/mle_fit.cu FULL,
   the fixed point every MLE kernel equals bit for bit) and its phase
   schedule (K2), for the methods sigmaxy and sigma, K2 == the one pass
   bit for bit; the LM fit kernel's one pass (K3, csrc/lq_fit.cu) and
   K6, JAX's fit in phases, which here is one launch of the LM work queue
   (csrc/roi_lq_queue.cu), K6 == K3 bit for bit; K1, the MLE work queue
   with the CRLB/LL in the kernel (csrc/roi_mle_fit.cu, 1 launch a fit),
   and K3 as a work queue (csrc/roi_lq_queue.cu), both with lane refill
   and a warp-cooperative straggler tail, == the one pass / K2 (sigmaxy,
   sigma) and K3/K6 bit for bit there and on make_spots at boxes 5, 9,
   11, 13 and 15, with their times (K1 in turns with the one pass),
   bounds, cooperative steps, registers, spills and resident blocks
   (none may spill at box 7); the fused
   cut+fit kernel
   (K5: MLE sigmaxy and sigma as the work queue with its CRLB/LL pass,
   in one pass and in the phase schedule, LM as the work queue with its
   cooperative tail) on the same spots laid out as a u16 and an f32
   frame chunk, K5 == K1/K2/K3 bit for bit there, with
   the queues' times, shares of their bounds, registers, spills and
   resident blocks per SM; K7, the sigmaxy fit in rounds of 8 on the
   TPU and one launch of K1's kernel here, == the one pass bit for bit
   (its plain version keeps the rounds); the identify
   kernel (K4) on one 256-frame 256x256 u16 chunk and on a (32, 2048,
   2048) chunk tiled 8x8 from its frames (torch_parity.compare_tiles),
   also timed per call in runs of 20 back-to-back calls, with its ptxas
   rows and resident blocks; times are medians of 5 CUDA-event runs of
   one call;
4. the MLE slice: picasso_torch.localize.localize (MLE sigmaxy, box 7)
   on a 2048-frame 256x256 u16 movie of tests/torch_data.make_bench_movie
   with the launch count of every kernel checked: K4 and K5's work queue
   (2 launches a chunk) launched, every other fit not; then its first
   chunk re-run through the plain versions on the card and held to the
   tolerances of tests/torch_parity.py; on that chunk K5 (queue, phases,
   one pass) == the gather route (cut, photons, K2, K1 or the one pass)
   bit for bit from u16 and f32 frames at two camera-constant pairs, K7
   == K1 == the one pass bit for bit, the routes timed in turns, the
   queue's time
   without the spots that run to max_it and on those spots alone, and
   the time of each stage of one chunk;
5. the MLE slice with mle_method="sigma" on the same movie: K4 and K5
   on the chain's sigma route (ops/fused.py MLE_FITS: the work queue, 2
   launches a chunk, or the phases, 3) launched on it, no other fit, sx
   == sy in every loc, its first chunk equal to a re-run and held
   against the plain sigma fit; K5's phases and its work queue for sigma
   in 5 alternating turns on chunk 0 (the rule behind MLE_FITS);
6. the LQ slice: localize(fitting_method="gausslq") on the same movie,
   with K4 and K5 LM's work queue launched on it, no other fit; its
   first chunk re-run through the plain versions on the card and held
   with compare_lq_fits; on that chunk K5 LM (from u16 and f32 frames,
   at two camera-constant pairs) == cut + photons + K3 bit for bit, its
   cooperative steps (> 0), the plain version's step counts
   (lq_step_stats), K5 against the gather route and K3 against K6 in
   turns, the tail split (lq_tail_split) and one max_it hit alone; the
   chunk's stages;
7. RCC undrift on the card: postprocess.undrift(device="cuda") of the
   MLE slice's locs with a known drift added, its residual against that
   drift, its agreement with the same call on the CPU, its wall split
   (render, pair FFTs, peak fits), and one launch of apply_drift's
   record kernel (csrc/records.cu) in it, no other counted kernel; the
   record kernel on those locs and that drift == its plain version on
   the card bit for bit, its device time beside its bytes bound and the
   plain version's time;
7a. a drift file: the RCC drift through io.save_drift and
   io.load_drift, applied again on the card, equal to undrift's locs bit
   for bit;
7b. AIM 2D: aim.aim (segments of 100 frames, two rounds) on the drifted
   locs on the card, its wall split into the device counts and the host
   rest, equal to the CPU run bit for bit, the residual against the
   injected drift;
7c. fiducials: 16 fiducial tracks away from the slice's locs added with
   the same drift; imageprocess.find_fiducials (the smooth render and K4,
   the path "fiducials") finds all 16 on the card, the picks equal the
   CPU's, and the drift from them (postprocess.undrift_from_fiducials)
   agrees with the CPU's and recovers the injected one;
7d. render: the undrifted (f64) locs at oversampling 10 (2560 x 2560)
   with every blur, timed on the card against one CPU call, the
   histogram equal to the CPU's and every blur within RENDER_AGREE;
8. the TIFF series: the movie written as movie.ome.tif + movie_1.ome.tif
   (tests/torch_data.write_tiff, 1024 frames each, in a folder of the
   checkout removed at the end), read back by io.load_movie (decode rate
   from the page cache), the MLE slice on it equal to the in-RAM slice
   bit for bit, K4 and K5's queue launched on it, the walls of both in
   turns;
9. avg: localize(fitting_method="avg") on the movie in RAM and on the
   TIFF series (K4 only), hit lists equal to the MLE slice's, the two
   movies' locs equal, chunk 0's photons equal to the CPU run and within
   torch_parity.compare_avg_photons of the f32 pairwise sum;
10. identify + fit2D: identify == the fused slice's hit list; fit2D
   gaussmle runs the route of ops/mle_cuda.ROI_FITS (K1: 1 launch a
   262,144-spot block; K2's phases: 3) and equals the
   MLE slice (K5's queue) bit for bit; fit2D gausslq runs K3 at max_it
   30 on the route of ops/lq_cuda.ROI_FIT (1 launch a block) and equals
   K5's LM queue at max_it 30 bit for bit, and the LQ slice on the spots
   that converge within 30 steps; on the first 262,144-ROI block K1 and
   K2 == the one pass bit for bit (MLE at max_it 100 and 6, where most
   fits are stragglers) and the LM queue == K3 and K6 (at 30 and 100);
   the card's sigmaxy fits there and on the later blocks within
   torch_parity.compare_fits of the plain fit, its sigma fits within
   compare_fits_dense (the gate for dense ROIs); the routes timed in 5
   alternating turns (the rule behind the route constants), each
   kernel's ms, bound and plain ms there, and the MLE tail split (the
   spots at max_it alone: K2's phases and K1);
11. astigmatic 3D: localize_3D (MLE and LQ) on the astigmatic recipe of
   tests/torch_data.py (2048 frames of 256x256, made alongside the
   build) with K4 and K5 launched, zfit's wall on the card, the card's
   z fit equal to the CPU's on chunk 0's locs bit for bit, the share of
   2D locs kept and z against the truth under bounds from the CPU run,
   and an RCC undrift that keeps z, d_zcalib and lpz;
12. AIM 3D: aim.aim on the localize_3D MLE locs with the x/y drift and a
   40 nm z sine, equal to the CPU run bit for bit, the z residual under
   AIM_Z_RESID (from the CPU run of tests/torch_aim_z_bound.py);
13. link -> dark -> groupprops on the undrifted MLE locs picked in
   circles of 0.5 px on the movie's sites (make_bench_movie's
   return_sites), at the link verb's defaults, with the host walk
   (csrc/link_walk.cu) launched once and no kernel; the card's CSR and
   chain ids equal the CPU's (the walk's Python twin), the events within
   one f32 ulp, the dark times equal, groupprops within one ulp; link's
   wall split into the candidates on the card, the CSR readback, the
   walk and the aggregation, beside the CPU's;
14. statistics: NeNA on the undrifted locs (histogram == the CPU's), FRC
   of the full field (card == CPU within 1e-9 on a 32 x 32 px
   viewport), the local density at 0.5 px (== cKDTree.query_ball_point),
   the pair correlation of phase 13's events at -b 0.1 -r 10 (== the CPU
   on a 48 px crop) and their nearest neighbours (== cKDTree.query);
15. the checks of localize -db (check_nena, check_kinetics, check_drift)
   on the undrifted MLE locs on the card, each against the CPU, and a
   summary row of them written to a database in a temporary directory
   and read back with sqlite3 (its declared types and values);
16. align_rcc on two channels, the undrifted MLE locs and a copy moved
   by ALIGN_OFFSET px, with each site's locs moved off the pixel
   lattice by a random sub-pixel amount (the movie's sites sit on
   integer pixels, where RCC at oversampling 1 cannot see a sub-pixel
   offset) and as they are: the offset left off the lattice under 0.1
   px, the card against the CPU within DRIFT_AGREE, the walls;
17. clustering (picasso_torch.clusterer; no kernel, the label sweep on
   the host, csrc/cluster_sweep.cu): through the entry points, with every
   count set to 0 just before, the SMLM clusterer (2D, frame analysis)
   on the undrifted MLE locs and its cluster centers, the SMLM clusterer
   in 3D on the localize_3D MLE locs (radius_z from their lpz), DBSCAN on
   the undrifted locs and HDBSCAN on a 32 x 32 px window of them; then
   the walls split (counts, neighbourhood max, the maxima's lists, the
   sweep; DBSCAN's passes; HDBSCAN's core distances, Prim and the host
   tree), and on a 64 x 64 px window the card's labels equal the CPU's
   for SMLM (2D, 3D) and DBSCAN, HDBSCAN's on the 32 x 32 px window, the
   centers within torch_parity.CENTERS_ULPS;
18. the analyses of grouped locs (no kernel; plain torch on the card):
   N_ORIGAMI DNA-PAINT origami (tests/torch_data.make_origami_locs,
   ~0.48 M locs), DBSCAN (ORIGAMI_R, ORIGAMI_DENSITY) into one cluster an
   origami, G5M (g5m.g5m, the batched EM of ops/gmm.py) and particle
   averaging (average.average, the device route, AVG_IT iterations at
   AVG_PX nm), each with every count set to 0 just before; G5M against
   the true sites and averaging against the true rotations under the
   bounds above; the walls split (G5M: the EM per K, the BIC readbacks,
   the host tables, the host-route fallbacks; the kernels and the time
   of one E+M step; averaging per iteration: rotations and histograms,
   FFTs and picks, the host rest); then the card against the CPU on
   N_CARD_CPU origami: G5M under torch_parity.compare_g5m (molecules per
   cluster equal but at BIC near ties; a cluster fit with the same K,
   start and steps within G5M_SAME_ULPS f32 ulps and its integer fields
   equal; another start or step count only at an EM near tie);
   averaging's first picks equal but at near ties;
19. SPINNA through the API (no kernel; plain torch on the card,
   picasso_torch.spinna and ops/spinna_batch.py), with every count set
   to 0 just before each fit: (a) the cell-scale field of
   tests/torch_data.SPINNA_CELL, brute force over its 231 candidates
   (best proportions within SPINNA_POINTS of the truth) and
   coarse-to-fine, the wall and candidates/s, the batched scorer's
   chunk, pads and peak memory, one chunk split by CUDA events into
   simulate / kNN / KS, and the scorer's bound (_spinna_bound); (b)
   bench.py's SPINNA recipe (1089 candidates, N_sim 4) after a warm call,
   its best monomer share within SPINNA_BENCH_POINTS of the truth, and
   fit_bayesian at its defaults with the bootstrap; (c) the card against
   the CPU on N_SPINNA_CARD_CPU candidates of (a) and of a tenth of it in
   3D, one seed, within torch_parity.compare_spinna_scores;
20. the rest of the localize API, nanotron, average3 and simulate
   through the API (no kernel is new): (a) on the slices' movie,
   identify_by_frame_number and identify_in_frame on API_FRAMES equal to
   identify's rows, localize with perf= (the wall split printed) equal
   to the MLE slice bit for bit, localize_fused with frame_chunk
   API_FRAME_CHUNK equal to the default bit for bit, an abort_callback
   that fires at the second chunk returning (None, None), the unit
   camera as 0-d arrays through identify + fit2D equal to the MLE slice
   bit for bit (path ``camera-array``), and the legacy fit of chunk 0's
   identifications (path ``fit``) related to fit2D's locs as ROADMAP
   queue 3 records (x/y in-box offsets swapped, box // 2 added, sx/sy
   swapped) within FIT_OFFSET_ABS px; (b) closed loop: simulate.
   simulate_movie (host) at SIM_CONFIGS, then localize on the card, more
   than SIM_MIN_LOCS locs with their median distance to the nearest
   site below SIM_MEDIAN_PX; (c) nanotron on two DNA-PAINT origami
   designs (origami_template() and its first two rows,
   N_NANO_PICKS picks a class, NANO_RADIUS px, oversampling
   NANO_OVERSAMPLING: 40 x 40 images), train_model at its defaults on
   N_NANO_TRAIN picks a class, held-out accuracy at least NANO_ACCURACY,
   predict_structure timed a pick; the card against the CPU from the
   same weights for NANO_CARD_CPU_EPOCHS epochs within
   torch_parity.compare_mlp; (d) average3: JAX's recipe
   (torch_data.make_average3_locs) at N_AVG3_GROUPS groups with JAX's
   gates (the spread falls by more than AVG3_SPREAD_FALL, the std of the
   groups' z means below AVG3_Z_STD nm), and N_ORIGAMI3D 3D origami
   (torch_data.make_origami3d_locs) at average3's defaults with the z
   gate, each pass's wall split; the card against the CPU pass by pass
   within torch_parity.compare_average3 (the recipe whole, the first
   N_AVG3_CARD_CPU origami). Paths ``simulate`` (the simulation),
   ``nanotron`` and ``average3`` launch no kernel;
21. the pick analyses and the Mask tool through the API (no kernel;
   plain torch on the card, host numpy/scipy where JAX uses the host) on
   phase 18's N_ORIGAMI origami: (a) pick_similar from circles of PICK_D
   px on the first N_SEED_PICKS true centres on the card and the CPU,
   held by torch_parity.compare_similar_picks, every pick within
   SIMILAR_TRUTH_PX of a true centre, then on the card alone on
   CAMERA_ORIGAMI origami (~2 M locs), the same gate, the walls split
   into the seeds' statistics, the walks and the host filter; (b)
   pick_properties (PROPS_RADIUS px circles, PROPS_DARK, PROPS_INFLUX),
   evaluate_picks and pick_kinetics of (a)'s picks, card == CPU (fits
   and counts equal, floats within one f32 ulp), pick_properties split
   into one link + dark_times on the card, the host fits and groupprops;
   (c) remove_locs_in_picks (host): the rows left and the picked rows
   make up the input; combine_locs_in_picks card == CPU within one ulp;
   (d) generate_image (MASK_PX nm, blur MASK_BLUR nm) card == CPU bit for
   bit, mask_image by every method of THRESHOLD_METHODS the CPU image's,
   mask_locs in + out = all. Paths ``picks`` ((a)-(c) on the card; the
   host link walk only) and ``mask`` launch no kernel.
22. the rest of render and io (no kernel; plain torch on the card, the
   scene's colours, the render index and the exporters on the host) on
   phase 11's localize_3D MLE locs with z and lpz in camera px: (a) every
   blur of the field at RENDER_OVERSAMPLING tilted by TILT and by (0, 0,
   0) on the card with walls, peak memory and the mass in view, the
   covariance splat split into rotation, covariances and bucket splats
   with its bucket counts, and on WINDOW_3D the card against the CPU
   (histograms, smooth, convolve equal but for the locs on a bin edge,
   counted; the splats within rtol 1e-5 + atol 1e-6); (b) render_hist3d
   and render_hist3d_anisotropic (axial HIST3D_Z_OVERSAMPLING) of the
   field over the locs' z range, the total the in-view count, card ==
   CPU on the window; (c) render_scene of the MLE and LQ locs with LUT
   colours and of the MLE locs with a LUT colormap at SCENE_PX nm, the
   window card vs CPU within one level; (d) build_render_index of the
   undrifted MLE slice and query_viewport of INDEX_VIEWS against a
   brute-force test of the index's blocks; (e) the five text exporters
   of the 3D locs into a temporary folder of the checkout, import_ts of
   the ThunderSTORM file back (frames equal, x and y within 2 f32 ulps).
   Path ``render3d`` launches no kernel;
23. several devices in one process (picasso_torch/parallel): (a) a mesh
   of every visible card, or MESH_SHARDS logical shards (in turns) of
   the one card, its cards and shards printed; (b) the main
   path, localize_fused MLE sigmaxy on the smoke movie over the mesh and
   on one card in MESH_TURNS turns, hits equal and theta/crlb/ll/iters
   bit for bit, both walls, the K4/K5 launches a shard (path ``mesh``);
   (c) fit_mle_sharded (both methods) and fit_lq_sharded on N_SPOTS
   make_spots == gaussmle / fit_spots_batched on one card bit for bit
   (paths ``mesh-fits``, ``mesh-fits-sigma``); (d) identify_sharded ==
   identify_frames, render_hist_sharded's sum == the locs in view,
   pair_xcorrs_sharded on phase 7's segments against pair_xcorrs (path
   ``mesh-stages``), spinna_score_sharded on phase 19's candidates bit for
   bit, fit_g5m_clusters_sharded on a bucket of phase 18's origami
   against the unsharded fit (the clusters equal bit for bit reported)
   and g5m over the mesh by compare_g5m (``mesh-spinna``,
   ``mesh-g5m``: no kernel); (e) dryrun_multichip over the mesh
   (``mesh-dryrun``); with two or more cards, each shard's outputs on its
   own card;
24. the folder watcher (picasso_torch/server/watcher.py) on the card: the
   smoke movie of phase 4 as one movie.ome.tif in a temporary folder of
   the checkout; watcher.watch(folder, poll_s=0, max_iterations=1,
   device="cuda") with every count set to 0 just before it and
   io.save_locs replaced by a capture (the machine has no h5py); the log
   has the movie's Processed line and no FAILED line, K4 launched once a
   chunk and K5's MLE work queue twice a chunk, no other fit (path
   ``watcher``); the captured locs equal a direct localize.localize on
   the card of io.load_movie of the file with the watcher's parameters
   (min. net gradient 5000, box 7, baseline 0, sensitivity 1, gain 1,
   pixel size 130) bit for bit, and the path is JAX's
   ``<movie without its last extension>_locs.hdf5`` beside the movie;
   the watcher's wall is printed with its split (discovery,
   wait_for_change's 2 s, the load, localize).
25. the render GUI's and the movie browser's calls on the card. The
   machine with the card has no matplotlib, which the apps' constructors
   import, so the phase builds picasso_torch.gui's RenderApp and
   LocalizeApp without a figure, with the state their constructors set
   (the apps' defaults), and calls their methods that reach the device:
   (a) RenderApp.render_scene of two channels, phase 7's undrifted MLE
   locs and phase 6's LQ locs, with LUT colours (render.stops_to_lut),
   blur smooth, oversampling 8, the whole field of view and then one
   ZOOM_STEP zoom in (dynamic oversampling): each frame's float images
   within RENDER_AGREE of the same app's on the CPU and the RGB within one
   level; draw_picks, draw_points (with get_rectangle_pick_polygon's
   corners), draw_scalebar, draw_legend and draw_minimap on the card's
   and the CPU's zoomed frames, the painted pixels equal; rgb_to_qimage
   raises ImportError (no PyQt6) (path ``render-gui``, no kernel);
   (b) LocalizeApp's preview (identify_current, frame 0 with an ROI) by
   compare_hits against the CPU's, localize_movie at the app's defaults
   (gausslq, its camera, min. net gradient 5000, box 7) == phase 6's LQ
   locs above 5000 bit for bit, identify + fit2D (gausslq) from those
   identifications == K5's LM queue at max_it 30 on the same hits bit
   for bit (path ``localize-gui``: K4 once a chunk of each call and once
   for the preview, K5's LM queue once a chunk, K3's queue once a block).
26. every box on the card (anybox_phase): (a) localize at box 17 (MLE
   sigmaxy, sigma, LQ) and 21 (MLE) on tests/torch_data.make_wide_movie
   (2048 frames of 256 x 256, ~100,000 spots 2.5 px wide, made alongside
   the build) through K4 at any box (csrc/identify_anybox.cu), the
   any-box cut (cut_anybox.cu) and the any-box fits (the work queues
   mle_anybox_queue.cu, lq_anybox_queue.cu), each launched once a chunk and no
   other kernel (paths ``box17-mle``, ``box17-mle-sigma``, ``box17-lq``,
   ``box21-mle``), hits == the plain versions on the card (compare_hits)
   and fits within compare_fits / compare_lq_fits; fit2D at box 17 on
   the MLE slice's identifications, both fitters (paths
   ``box17-fit2D-mle``, ``box17-fit2D-lq``: the any-box fit only), held
   likewise; walls and spots/s; the box-17 MLE and LQ chains split a
   chunk (upload, K4, compaction, cut, fit; ms of each of the 8 chunks);
   (b) bit for bit: the any-box MLE queue == its one-thread pass
   (mle_anybox.cu) at boxes 4, 8, 16, 17, 21 (make_spots, 8192 a box)
   and 45 (2048; no stage: the pixels from the batch), both methods; the
   any-box LM queue == its one-thread pass (lq_anybox.cu) at the same
   boxes and 120 (256 spots; no stage); the tiled cut
   == its direct kernel == photons_t at 4, 7, 15, 17, 21, u16 and f32;
   the MLE queue and one-thread pass and both LM kernels == the
   templated K1 / K3 queues at boxes 5-15; K4 at any box == identify.cu at 3-15 on phase
   3's chunk and == its direct kernel at 4, 17 and 21 on the wide
   movie's first chunk, there within compare_tiles of the plain version,
   and at box 97, where no tile fits, K4 (the direct kernel) within
   compare_tiles of it on 4 of its frames; the any-box cut + fits == K5's queues at 7 and 15; and at box 3 K1,
   K2, K7, K5 (queue, phases, one pass), K3's queue, K6 and K5's LM queue
   == the one-thread passes on 131,072 make_spots, held to the plain
   fits by compare_fits_max_it (max_it 5) and compare_lq_fits' box-3
   bounds, the any-box bodies == those passes at box 3 too and timed in
   turns with K1 and K3's queue there; then the any-box kernels timed at
   box 17 (make_spots, 131,072, made alongside the build; K4 on the wide
   movie's first chunk, its bound counted from its maxima) against their
   plain versions, the MLE and LM queues in turns with their one-thread
   passes, the cut and K4 with their direct kernels, for the kernels
   line; (c) boxes 1 and 2 (small_box_phase): gaussmle (sigmaxy,
   sigma) and gausslq.fit_spots on make_spots(131072, box, 0), fit2D
   (MLE, LQ, avg) of the bench movie's box-3 identifications on its
   first 256 frames (paths ``box1-mle``, ``box1-mle-sigma``,
   ``box1-lq``, ``box1-fit2D-mle``, ``box1-fit2D-lq``,
   ``box1-fit2D-avg`` and ``box2-*``: the any-box MLE or LM queue once,
   avg none), each == the any-box one-thread pass bit for bit, held to
   the plain fits by the tests' comparisons (box 1 compare_fits_max_it
   at max_it 5 and the LM bit for bit; box 2 compare_fits_rounding /
   compare_lq_fits_rounding against the plain fit in f64), avg within
   compare_avg_photons; the tiled cut == its direct kernel == photons_t
   (u16, f32); identify refused (ValueError) at both boxes; the queues
   and the cut timed in turns with their first forms (the kernels
   line's ``box1_*`` and ``box2_*`` keys).
IMS and STK movies are checked on the CPU only (tests/test_torch_io.py):
the machine with the card has no h5py, and the CLI's verbs run on the
CPU only. The apps' figures are held to the JAX package's on the CPU
(tests/test_torch_gui_apps.py, test_torch_render_gui.py,
test_torch_gui_panels.py, test_torch_viewers.py).
The line before the last is the JSON record of every kernel (bound_ms:
the larger of the FLOPs this run's inputs need over 67 TFLOP/s f32 and
the bytes read once and written once over 3.35 TB/s, NVIDIA's H100 SXM
peaks); the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BOX = 7
EPS = 1e-3
FTOL = 1e-6
MAX_IT = 100
MIN_NG = 4000
N_SPOTS = 131072
CHUNK = 256  # frames per chunk that localize_fused forms at 256x256
ROUND_IT = 8  # K7's iterations a round
SEGMENTATION = 128  # frames an RCC segment: 16 segments of the movie
DRIFT_RESID = 0.1  # px, RMS residual of the recovered drift
DRIFT_AGREE = 1e-2  # px, undrift on the card against the CPU
AIM_SEGMENTATION = 100  # frames an AIM segment, the CLI's default
N_FIDUCIALS = 16
FID_RESID = 0.05  # px, RMS residual of the drift from fiducials
FID_AGREE = 1e-9  # px, drift from fiducials on the card against the CPU
RENDER_OVERSAMPLING = 10.0  # a 2560 x 2560 image of the 256 x 256 movie
# max |card - CPU| / max of the CPU image per blur: the counts and the
# filters' f64 terms are exact; the splats sum f32 windows in any order
# and take the card's exp
# AIM 3D: the z drift injected into the localize_3D locs (nm, a sine
# over the movie) and the bound on AIM's z residual RMS, about twice the
# 2.29 nm of the CPU run of the same recipe on 512 frames
# (tests/torch_aim_z_bound.py, PERF.md)
AIM_Z_DRIFT = 40.0
AIM_Z_RESID = 5.0
RENDER_AGREE = {"None": 0.0, "smooth": 1e-6, "convolve": 1e-6,
                "gaussian": 1e-5, "gaussian_iso": 1e-5}
PEAK_F32 = 67e12  # FLOP/s, f32 outside the tensor cores (H100 SXM)
PEAK_BYTES = 3.35e12  # B/s, HBM3 (H100 SXM)
# localize_3D on the astigmatic movie: (least share of the 2D locs kept,
# z RMS nm, median |z - truth| nm against the truth), from the CPU run
# of tests/torch_data.make_astig_movie at this density (PERF.md): MLE
# kept 0.911, RMS 102.7, median 13.2; LQ 0.989, 118.2, 11.4
Z_BOUNDS = {"gaussmle": (0.88, 130.0, 20.0), "gausslq": (0.96, 150.0, 18.0)}
PICK_RADIUS = 0.5  # px, the circles picked on the movie's sites
LINK_D_MAX, LINK_TOL = 1.0, 1  # the link verb's defaults
DENSITY_R = 0.5  # px
PC_BIN, PC_RMAX = 0.1, 10.0  # the pc verb's defaults
CROP = 48  # px, the crop of the events on which pc is held to the CPU
FRC_VIEW = ((112.0, 112.0), (144.0, 144.0))  # 32 x 32 px, card vs CPU
# clustering (phase 17): the SMLM clusterer's radius, about 3x the NeNA of
# the undrifted MLE locs (0.01676 px, phase 15), its min. locs, DBSCAN's
# radius and density, HDBSCAN's min. cluster size and samples; the windows
# (x0, y0, side) px where the card is held to the CPU (HDBSCAN's O(N^2)
# Prim runs on the smaller one), and radius_z as a multiple of the median
# lpz of the localize_3D MLE locs
CLUSTER_R, CLUSTER_MIN = 0.05, 10
HDBSCAN_MIN = 10
WINDOW_64, WINDOW_32 = (96.0, 96.0, 64.0), (112.0, 112.0, 32.0)
RADIUS_Z_LPZ = 3.0
# phase 18: one field of view of DNA-PAINT origami
# (tests/torch_data.make_origami_locs), DBSCAN's radius (px) and density
# that make each origami one cluster (sites 0.154 px apart, neighbours
# at least 3 px), averaging's display pixel (nm) and iterations; the
# gates, written before the first chip run from the CPU runs of the same
# recipe (PERF.md): the share of true sites within G5M_PX of a
# G5M center and of centers within G5M_PX of a site (CPU, 64 origami:
# 0.9986 and 1.0), the share of origami whose rotation relative to the
# consensus lies within 2 angle steps of the truth (CPU, 1000 origami,
# seeds 0-5: 0.969-0.998) and of the truth or its turn by pi (1.0)
N_ORIGAMI, ORIGAMI_SEED = 1000, 0
ORIGAMI_R, ORIGAMI_DENSITY = 0.1, 10
AVG_PX, AVG_IT = 5.0, 3
G5M_PX, G5M_SITES, G5M_CENTERS = 0.05, 0.95, 0.98
ROT_SHARE, ROT_SHARE_PI = 0.9, 0.98
# card == CPU on the first N_CARD_CPU origami: G5M under
# tests/torch_parity.compare_g5m's bounds, averaging's first picks equal
# but at near-tie correlations (relative)
N_CARD_CPU = 64
PICK_TIE = 1e-5
# phase 19: SPINNA on the cell-scale field of tests/torch_data.SPINNA_CELL
# (5000 A in 1500 monomers, 1000 dimers at 20 nm and 500 trimers with 20
# nm sides, 30 / 40 / 30 % by target), the search space at granularity 21
# (231 candidates), N_sim 3; brute force's best proportions within
# SPINNA_POINTS of the truth (JAX's host scorer found them exactly on this
# field at seeds 19 and 20). bench.py's recipe (:1184-1221): monomer + 20
# nm dimer, 300 + 250 in 4 x 4 um, LE 0.9, unc 2, N_sim 4, its 33 x 33
# grid; the best monomer share within SPINNA_BENCH_POINTS of the truth,
# 37.5 % (JAX's host scorer: 37.7 %). Card == CPU on N_SPINNA_CARD_CPU
# candidates of the field at N_sim 1 and on a tenth of it in 3D.
SPINNA_GRANULARITY, SPINNA_NSIM = 21, 3
SPINNA_POINTS, SPINNA_BENCH_POINTS = 10.0, 12.0
N_SPINNA_CARD_CPU = 8
# phase 20: the frames on which the legacy identification API is held to
# identify, the frame chunk held to the default, and the bound of the
# legacy fit's relation to fit2D (two f32 ulps of a coordinate below 256
# px); the closed loop's simulations (JAX's tests/test_simulate.py recipe,
# then a 64 x 64 px, 1000-frame, 32-site movie), their localize settings
# and JAX's gates; nanotron's data (picks a class, the training picks,
# the pick radius (px) and oversampling, the seeds of the two designs),
# its accuracy gate, the epochs of card == CPU and the picks
# predict_structure is timed on; average3's groups of JAX's recipe, its
# 3D origami and those held card == CPU, and JAX's gates
API_FRAMES = (0, 1, 1000, 2047)
API_FRAME_CHUNK = 128
FIT_OFFSET_ABS = 2 * float(np.spacing(np.float32(256)))
SIM_CONFIGS = (
    dict(n_sites=16, imagesize=32, frames=400, taud=3000, photonrate=60,
         seed=7),
    dict(n_sites=32, imagesize=64, frames=1000, taud=3000, photonrate=60,
         seed=7),
)
SIM_MIN_NG, SIM_MIN_LOCS, SIM_MEDIAN_PX = 3000, 50, 1.0
N_NANO_PICKS, N_NANO_TRAIN = 500, 400
NANO_RADIUS, NANO_OVERSAMPLING, NANO_SEEDS = 0.5, 40, (31, 32)
NANO_ACCURACY, NANO_CARD_CPU_EPOCHS, N_PREDICT = 0.95, 5, 20
N_AVG3_GROUPS, N_ORIGAMI3D, N_AVG3_CARD_CPU = 1000, 1000, 64
AVG3_SPREAD_FALL, AVG3_Z_STD = 0.3, 10.0
# phase 21: picks and masks on phase 18's origami field: the seed picks
# (circles of PICK_D px on the true centres of the first N_SEED_PICKS
# origami), the camera-sized field of CAMERA_ORIGAMI origami, the truth
# gate (px; JAX's CPU run on the 1000 origami: 254 picks, the farthest
# 0.033 px from a centre), the circles of pick_properties (radius px),
# its dark time and influx rate, and the Mask tool's pixel and blur (nm)
PICK_D, N_SEED_PICKS, CAMERA_ORIGAMI, CAMERA_SEED = 1.0, 20, 4096, 1
SIMILAR_TRUTH_PX = 0.05
PROPS_RADIUS, PROPS_DARK, PROPS_INFLUX = 0.5, 3, 0.03
MASK_PX, MASK_BLUR = 65.0, 100.0
# phase 22: rotated and 3D renders, the scene, the render index and the
# exporters on phase 11's localize_3D locs: the tilt (Euler angles, rad);
# the window where the card is held to the CPU (80 x 80 px, ~85,000 of
# the locs in view: both sides on JAX's device route, from
# ops/render_ops.DEVICE_MIN_LOCS); the axial oversampling of the
# anisotropic 3D histogram; the scene's display pixel (nm, oversampling
# 10 at 130 nm); and the viewports (y0, x0), (y1, x1) px of the render
# index's queries, the last the whole field (bypassed)
TILT = (0.3, 0.5, 0.2)
# phase 23: several devices in one process (picasso_torch/parallel): the
# shards a mesh holds when one card is visible (logical shards, in
# turns), the turns of the main path on one card and over the
# mesh, the seed of the SPINNA draws, and G5M's K and starts of the
# direct bucket fit
MESH_SHARDS = 4
MESH_TURNS = 3
MESH_SPINNA_SEED = 23
MESH_G5M_K, MESH_G5M_STARTS = 11, 3

# the min. blur (px) of phase 22's renders, as a user sets it in Render:
# each splat at least 0.5 display px wide, so that its sum over the pixel
# centres is within a few % of its mass wherever the loc sits (the
# movie's sites sit on the camera's grid: at 0.2 display px a loc on a
# pixel corner sums to 0.70; at 0 and 0.02 px the untilted splats of
# this phase keep 62% and 71% of the mass, at 0.05 px 99.4%)
RENDER3D_MIN_BLUR = 0.05
WINDOW_3D = ((88.0, 88.0), (168.0, 168.0))
HIST3D_Z_OVERSAMPLING = 5.0
SCENE_PX = 13.0
INDEX_VIEWS = (((100.0, 100.0), (120.0, 130.0)), ((0.0, 0.0), (40.0, 40.0)),
               ((200.5, 10.2), (255.9, 60.3)), ((0.0, 0.0), (256.0, 256.0)))


def _median_ms(fn, reps: int = 5, calls: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up,
    each of ``calls`` back-to-back calls, per call (with calls > 1 one
    call's host work hides behind the previous call's kernel)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


#: calls in a torch.profiler trace of :func:`_kernel_device_ms`
PROFILED_CALLS = 10


def _kernel_device_ms(fn, name: str):
    """The device time in ms of one call of the kernels whose name holds
    ``name``, from a torch.profiler trace of PROFILED_CALLS calls of
    ``fn`` after a warm-up (the kernel alone, without the host work or
    other launches of its wrapper), or None where the trace shows no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
                for ev in prof.key_averages() if name in ev.key)
    return total / PROFILED_CALLS / 1e3 if total else None


def _ms_or_not(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def _once_ms(fn, warm: bool = True):
    """(fn() of a first call, the CUDA-event time in ms of a second): a
    steady-state time of one call after a warm-up that also gives the
    output, for a plain version whose one call takes seconds and whose
    output is the reference of the kernel's check. ``warm=False``: the
    caller has just run the same work on the same inputs, so one timed
    call gives both."""
    import torch

    out = fn() if warm else None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    last = fn()
    end.record()
    torch.cuda.synchronize()
    return (last if out is None else out), start.elapsed_time(end)


def mle_flops_per_spot_iter(box: int) -> float:
    """FLOPs of one Newton step of one spot (the analytic count of
    bench.py:136, exp/erfc at 8 FLOPs each)."""
    s = box
    return float(s * s * 29 + 17 * 2 * s + 2 * (s + 1) * 2 * 8
                 + 2 * s * 24 + 90)


def lq_flops_per_spot_iter(box: int) -> float:
    """FLOPs of one LM iteration of one spot as csrc/lq_fit.cu computes
    it, exp at 8 FLOPs: the J^T r pass (10 a pixel, 12 a row), the trial
    cost (5 a pixel, 2 a row), the axis factors (19 a point with the
    derivatives, 13 without, for both axes), the 20 1D dot products of
    J^T J (2 a point) and its 21 scaled entries, the damped 6x6 Cholesky
    solve and the update (~295 in all). (bench.py:154 counts 27 FMAs a
    pixel for a dense J^T J assembly; the separable form needs none.)"""
    s = box
    return float(15 * s * s + 118 * s + 295)


def lq_normal_flops(box: int) -> float:
    """The part of :func:`lq_flops_per_spot_iter` that forms the normal
    equations: the J^T r pass (10 a pixel, 12 a row), the axis factors
    with their derivatives (38 a point), the 20 dot products (40 a
    point) and the 21 scaled entries (63). A rejected step leaves theta
    as it was, so the LM kernels (csrc/fit_lq.cuh) reuse these numbers
    at the step after it."""
    s = box
    return float(10 * s * s + 90 * s + 63)


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take, and what sets it."""
    t_ops = flops / PEAK_F32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _fit_bound(n: int, iters_sum: float, per_iter, out_bytes: int,
               in_bytes: int = BOX * BOX * 4, box: int = BOX):
    """Bound of a fit of n spots (box 7 by default): the iterations these
    spots need plus one for the initialiser and the final pass, each
    spot's input read once (by default its f32 ROI; K5 reads a u16 window
    and three i32 hit indices) and its results written once."""
    return _bound((iters_sum + n) * per_iter(box),
                  n * (in_bytes + out_bytes))


K5_IN_BYTES = BOX * BOX * 2 + 3 * 4  # u16 window + (f, y, x) int32


def lq_fit_bound(n: int, steps: float, reused: float,
                 in_bytes: int = BOX * BOX * 4, box: int = BOX):
    """Bound of an LM fit of n spots (box 7 by default) that takes
    ``steps`` steps in all, ``reused`` of them right after a rejected
    step of the same spot (:func:`lq_iters`): a full step each and one
    more a spot for the
    initialiser, less the normal equations of each reused step, which
    the function need not form again; each spot's input read once and
    its theta (24 B) written once."""
    return _bound((steps + n) * lq_flops_per_spot_iter(box)
                  - reused * lq_normal_flops(box), n * (in_bytes + 24))


K4_CALLS = 20  # back-to-back K4 calls of its extra timing
ROUTE_TURNS = 5  # alternating turns a route of fit2D is timed in
STRAGGLER_IT = 6  # a max_it at which most fit2D MLE fits are stragglers


def _alternate(fns, turns: int = ROUTE_TURNS) -> list[list[float]]:
    """``turns`` CUDA-event timings of one call of each of ``fns``, taken
    in turn (A B A B ...) after a warm-up call of each; returns each
    function's times (ms)."""
    import torch

    for fn in fns:
        fn()
    out = [[] for _ in fns]
    for _ in range(turns):
        for times, fn in zip(out, fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    return out


def _turns(fns, reps: int = 5) -> list[float]:
    """Median times of ``fns`` taken in the given order (A, B, B, A),
    so that a drift of the card's clock shows."""
    return [_median_ms(fn, reps) for fn in fns]


def _assert_equal(a, b, what: str) -> None:
    """Equal bit for bit, NaN where NaN, output by output."""
    for x, y, name in zip(a, b, ("theta", "crlb", "ll", "iters")):
        if not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"{what}: not equal bit for bit ({name})")


def _plain_multiround(spots_t, max_it: int):
    """The plain version of K7 on the spots' device: the schedule of
    ops/mle_cuda.fit_multiround_t over the plain phases of ops/mle.py."""
    from picasso_torch.ops import mle
    from picasso_torch.ops._fit_common import FINISH, phase_ends, run_phases

    def phase(mode, spots, k, carry):
        return mle._fit_phase(mode, spots, EPS, k, "sigmaxy", None, carry)

    (theta, crlb, ll, iters), inv = run_phases(
        phase, spots_t, max_it,
        phase_ends(range(ROUND_IT, max_it, ROUND_IT), max_it), 2, FINISH)
    return theta[:, inv], crlb[:, inv], ll[inv], iters[inv]


def lq_iters(spots_t, max_it: int, ftol: float = FTOL):
    """The plain version's LM steps on each spot (the LQ kernels return
    theta only): (steps, rejected steps, steps after a rejected step of
    the same spot, whose normal equations a kernel may reuse), numpy f32
    (N,) each."""
    import torch

    from picasso_torch.ops import lq

    carry = lq._lm_init(spots_t)
    n = spots_t.shape[-1]
    steps, rejected, reused = (torch.zeros(n, device=spots_t.device)
                               for _ in range(3))
    last_rejected = torch.zeros(n, dtype=torch.bool, device=spots_t.device)
    for _ in range(max_it):
        active = carry[3][0] < 0.5
        if not bool(active.any()):
            break
        old = carry[2][0]
        reused += (active & last_rejected).float()
        carry = lq._lm_rounds(spots_t, *carry, 1, ftol)
        new = carry[2][0]
        rej = active & ((new == old) | (new.isnan() & old.isnan()))
        steps += active.float()
        rejected += rej.float()
        last_rejected = torch.where(active, rej, last_rejected)
    return tuple(a.cpu().numpy() for a in (steps, rejected, reused))


LONG_FIT = 30  # steps: the straggler tail of the LM fit


def lq_step_stats(steps, max_it: int, rejected=None, reused=None,
                  warp: int = 32) -> dict:
    """The distribution of the LM steps over the spots in input order:
    percentiles, the count at max_it, the share of all spot-steps in fits
    of more than LONG_FIT steps, and warp max / mean: for each run of
    ``warp`` consecutive spots the slowest one's steps, summed over the
    runs, times ``warp``, over the total steps (what divergence costs a
    kernel of one thread a spot); with ``rejected``/``reused``, their
    shares of all steps."""
    it = np.asarray(steps, np.float64)
    total = max(it.sum(), 1.0)
    runs = np.concatenate([it, np.zeros(-len(it) % warp)]).reshape(-1, warp)
    out = {"spots": len(it), "mean": round(float(it.mean()), 3) if len(it)
           else 0.0}
    for q in (50, 90, 99, 100):
        out[f"p{q}"] = float(np.percentile(it, q)) if len(it) else 0.0
    out["at_max_it"] = int((it == max_it).sum())
    out[f"share_over_{LONG_FIT}"] = round(float(it[it > LONG_FIT].sum()
                                                / total), 4)
    out["warp_max_over_mean"] = round(float(runs.max(1).sum() * warp
                                            / total), 3)
    if rejected is not None:
        out["rejected"] = round(float(np.sum(rejected) / total), 4)
    if reused is not None:
        out["reusable"] = round(float(np.sum(reused) / total), 4)
    return out


def lq_tail_split(fit, frames, hits, steps) -> dict:
    """The straggler tail of an LM fit: ``fit(frames, hits)`` timed (ms,
    median of 5) on the hits that run to MAX_IT alone, on those of more
    than LONG_FIT steps alone and on the rest alone, in turns (A B C C B
    A); ``steps`` are the plain version's steps of each hit."""
    import torch

    it = torch.from_numpy(np.asarray(steps)).to(frames.device)
    masks = {"max_it": it == MAX_IT, f"> {LONG_FIT}": it > LONG_FIT,
             f"<= {LONG_FIT}": it <= LONG_FIT}
    sub = {k: [h[m] for h in hits] for k, m in masks.items()}
    order = [*sub, *reversed(sub)]
    t = _turns(lambda k=k: fit(frames, sub[k]) for k in order)
    return {k: {"hits": int(masks[k].sum()),
                "ms": [round(t[i], 4), round(t[len(order) - 1 - i], 4)]}
            for i, k in enumerate(sub)}


def _ptxas_table(log: str) -> list[str]:
    """One line per compiled kernel instance: template arguments,
    registers and spill bytes, from nvcc's -Xptxas -v report."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '.*?((?:identify|lq_fit|mle_fit|"
                      r"mle_queue|winfit_mle|lq_queue|mle_any_queue|"
                      r"identify_any|lq_any_queue|cut_any)_kernel)"
                      r"I(\w+?)EEv", line)
        if m:
            args = re.sub(r"NS_\d+ChunkWindowsI(\w)EE", r"Chunk<\1>",
                          m.group(2))
            args = re.sub(r"NS_\d+RoiBatchE", "RoiBatch", args)
            name, spill = f"{m.group(1)}<{args}>", ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return rows


def link_phase(locs, info, sites, counted, smi: str):
    """13. link -> dark -> groupprops on the card: the locs in circles of
    PICK_RADIUS px on the movie's sites (one group a site), linked with
    the link verb's defaults, their dark times and group properties,
    through the entry points with every count set to 0 just before (the
    host walk of csrc/link_walk.cu launched once, no kernel of the
    localize path); then link's split (candidates on the card, the CSR
    read back, the walk, the aggregation) and the same pieces on the CPU
    (the walk's Python twin): CSR and chain ids equal, the events within
    one f32 ulp, the dark times equal, groupprops within one ulp. Returns
    (events, launches, walls)."""
    import torch

    from picasso_torch import postprocess
    from picasso_torch.ops import link as link_ops
    from torch_parity import compare_tables_ulps

    picks = [(float(c), float(r)) for r, c in sites]
    t0 = time.perf_counter()
    picked = np.concatenate(postprocess.picked_locs(
        locs, info, picks, "Circle", pick_size=PICK_RADIUS))
    picked = picked[np.argsort(picked["frame"], kind="stable")]
    pick_s = time.perf_counter() - t0

    steps = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    def main_path():
        linked = step("link", lambda: postprocess.link(
            picked, info, r_max=LINK_D_MAX, max_dark_time=LINK_TOL,
            device="cuda"))
        dark = step("dark", lambda: postprocess.compute_dark_times(
            linked, device="cuda"))
        return linked, dark, step("groupprops", lambda: postprocess.groupprops(
            dark, device="cuda"))

    (linked, dark, groups), wall, launches = counted(main_path)
    if launches["link walk"] != 1 or any(
            v for k, v in launches.items() if k != "link walk"):
        raise AssertionError(f"link -> dark -> groupprops launched {launches}")
    cols = (picked["frame"].astype(np.int64), picked["x"], picked["y"],
            picked["group"].astype(np.int64))

    def t(a, d="cpu"):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)

    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    off, succ = link_ops.successors(*(t(a, "cuda") for a in cols),
                                    LINK_D_MAX, LINK_TOL)
    sync()
    t1 = time.perf_counter()
    off_h, succ_h = off.cpu().numpy(), succ.cpu().numpy()
    t2 = time.perf_counter()
    ids = link_ops.walk_host(off_h, succ_h)
    t3 = time.perf_counter()
    events = postprocess._link_loc_groups(picked, info, t(ids, "cuda"))
    sync()
    t4 = time.perf_counter()
    off_c, succ_c = link_ops.successors(*(t(a) for a in cols), LINK_D_MAX,
                                        LINK_TOL)
    t5 = time.perf_counter()
    ids_c = link_ops.walk_plain(off_c.numpy(), succ_c.numpy())
    t6 = time.perf_counter()
    events_c = postprocess._link_loc_groups(picked, info, t(ids_c))
    t7 = time.perf_counter()
    if not (np.array_equal(off_h, off_c.numpy())
            and np.array_equal(succ_h, succ_c.numpy())
            and np.array_equal(ids, ids_c)):
        raise AssertionError("link: the card's CSR or chain ids differ from "
                             "the CPU's")
    ulp_link = compare_tables_ulps(linked, events_c, 1, "link card vs CPU")
    compare_tables_ulps(events, events_c, 1, "link split vs CPU")
    dark_c = postprocess.dark_times(linked, device="cpu")
    if not np.array_equal(dark["dark"], dark_c[dark_c != -1]):
        raise AssertionError("dark times: card differs from the CPU")
    ulp_gp = compare_tables_ulps(groups, postprocess.groupprops(
        dark, device="cpu"), 1, "groupprops card vs CPU")
    walls = {"link": t4 - t0, "candidates": t1 - t0, "readback": t2 - t1,
             "walk": t3 - t2, "aggregation": t4 - t3, "cpu": t7 - t4,
             "cpu walk": t6 - t5}
    print(f"link -> dark -> groupprops ({smi}): {len(picked)} locs in "
          f"{len(picks)} picks of {PICK_RADIUS} px ({pick_s:.3f} s to pick) "
          f"-> {len(linked)} events (d_max {LINK_D_MAX} px, tolerance "
          f"{LINK_TOL}; mean len {linked['len'].mean():.3f} frames, mean n "
          f"{linked['n'].mean():.3f}) -> {len(dark)} with a dark time -> "
          f"{len(groups)} groups: card {wall:.3f} s (link "
          f"{steps['link']:.3f} s, dark {steps['dark']:.3f} s, groupprops "
          f"{steps['groupprops']:.3f} s), launches {launches}")
    print(f"  link split on the card: candidates {t1 - t0:.3f} s "
          f"({len(succ_h)} successors of {len(picked)} locs), CSR readback "
          f"{t2 - t1:.3f} s, walk (csrc/link_walk.cu) {t3 - t2:.3f} s, "
          f"aggregation {t4 - t3:.3f} s = {t4 - t0:.3f} s; CPU: candidates "
          f"{t5 - t4:.3f} s, walk (Python twin) {t6 - t5:.3f} s, aggregation "
          f"{t7 - t6:.3f} s = {t7 - t4:.3f} s")
    print(f"  card == CPU: CSR and chain ids equal; events within one f32 "
          f"ulp ({ulp_link} cells differ); dark times equal; groupprops "
          f"within one ulp ({ulp_gp} cells differ)")
    return linked, launches, walls


def stats_phase(locs, info, events, smi: str):
    """14. the statistics on the card, each wall with the card's name and
    power limit: NeNA on the locs (histogram == the CPU's), FRC on the
    full field (card against the CPU on the FRC_VIEW viewport), the local
    density at DENSITY_R px (== cKDTree.query_ball_point), the pair
    correlation of the events at the pc verb's defaults (== the CPU on a
    CROP px crop) and their nearest neighbours (== cKDTree.query).
    Returns the walls."""
    import torch
    from scipy.spatial import cKDTree

    from picasso_torch import lib, postprocess

    dev = "cuda"
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    res, s = timed("nena", lambda: postprocess.nena(locs, device=dev))
    _, h_c = timed("nena hist cpu", lambda:
                   postprocess._next_frame_neighbor_distance_histogram(
                       locs, device="cpu"))
    if not np.array_equal(res["data"], h_c):
        raise AssertionError("NeNA histogram: card differs from the CPU")
    info_px = [dict(info[0], Pixelsize=130)]
    full = ((0, 0), (info[0]["Height"], info[0]["Width"]))
    torch.cuda.reset_peak_memory_stats()
    frc_full = timed("frc", lambda: postprocess.frc(locs, info_px, full,
                                                    device=dev))
    peak = torch.cuda.max_memory_allocated() / 2**30
    frc_px = frc_full.pop("images")[0].shape[0]
    fg = timed("frc view", lambda: postprocess.frc(locs, info_px, FRC_VIEW,
                                                   device=dev))
    fc = timed("frc view cpu", lambda: postprocess.frc(locs, info_px,
                                                       FRC_VIEW,
                                                       device="cpu"))
    frc_err = float(np.abs(fg["frc_curve"] - fc["frc_curve"]).max())
    if frc_err > 1e-9 or fc["resolution"] is None or abs(
            fg["resolution"] / fc["resolution"] - 1) > 1e-6:
        raise AssertionError(f"FRC on the viewport: card differs from the "
                             f"CPU ({frc_err}, {fg['resolution']}, "
                             f"{fc['resolution']})")
    if frc_full["resolution"] is None or not np.isfinite(
            frc_full["frc_curve"]).all():
        raise AssertionError("FRC of the full field: no resolution")
    dens = timed("density", lambda: postprocess.compute_local_density(
        locs, info, DENSITY_R, device=dev))
    sane = lib.ensure_sanity(locs, info)
    pts = np.column_stack([sane["x"], sane["y"]])
    want = timed("density kdtree", lambda: cKDTree(pts).query_ball_point(
        pts, DENSITY_R, return_length=True, workers=-1) - 1)
    if not np.array_equal(dens["density"], want):
        raise AssertionError("density differs from cKDTree")
    bins, pc = timed("pc", lambda: postprocess.pair_correlation(
        events, info, PC_BIN, PC_RMAX, device=dev))
    crop = events[(events["x"] < CROP) & (events["y"] < CROP)]
    if not np.array_equal(
            postprocess.distance_histogram(crop, info, PC_BIN, PC_RMAX,
                                           device=dev),
            postprocess.distance_histogram(crop, info, PC_BIN, PC_RMAX,
                                           device="cpu")):
        raise AssertionError("pair histogram of the crop: card differs from "
                             "the CPU")
    X = np.column_stack([events["x"], events["y"]])
    nn = timed("nn", lambda: postprocess.nn_analysis(X, X, 1, device=dev))
    want_nn = timed("nn kdtree", lambda: cKDTree(X).query(
        X, 2, workers=-1)[0][:, 1:])
    if not np.array_equal(nn, want_nn):
        raise AssertionError("nn_analysis differs from cKDTree")
    n_pairs = int(np.round(pc * np.pi * PC_BIN * (2 * bins + PC_BIN)).sum())
    print(f"NeNA ({smi}): {len(locs)} locs, {int(res['data'].sum())} "
          f"next-frame pairs, s {s:.5f} px: card {walls['nena']:.3f} s "
          f"(histogram == the CPU's, {walls['nena hist cpu']:.3f} s)")
    print(f"FRC ({smi}): full field {full} at bins of NeNA / 2 "
          f"({frc_px} px square), resolution "
          f"{frc_full['resolution']:.3f} nm: card {walls['frc']:.3f} s, peak "
          f"{peak:.2f} GiB; {FRC_VIEW} viewport ({fg['images'][0].shape[0]} "
          f"px): card {walls['frc view']:.3f} s, CPU "
          f"{walls['frc view cpu']:.3f} s, curve max |d| {frc_err:.3g}, "
          f"resolution {fg['resolution']:.4f} vs {fc['resolution']:.4f} nm")
    print(f"density ({smi}): r {DENSITY_R} px on {len(dens)} locs (mean "
          f"{dens['density'].mean():.1f} neighbours): card "
          f"{walls['density']:.3f} s == cKDTree.query_ball_point "
          f"({walls['density kdtree']:.3f} s on the host)")
    print(f"pc ({smi}): -b {PC_BIN} -r {PC_RMAX} on {len(events)} events "
          f"({n_pairs} pairs): card {walls['pc']:.3f} s; the {CROP} px crop "
          f"({len(crop)} events) == the CPU")
    print(f"nn_analysis ({smi}): k 1 on {len(events)} events: card "
          f"{walls['nn']:.3f} s == cKDTree.query ({walls['nn kdtree']:.3f} s "
          f"on the host)")
    return walls


def db_phase(locs, info, counted, smi: str):
    """15. the checks of ``localize -db`` on the card: localize.check_nena,
    check_kinetics and check_drift on the undrifted MLE locs with every
    count set to 0 just before (the host walk of link launched once, and
    apply_drift's record kernel once, in check_drift's undrift; no other
    kernel), each against the same call on the CPU (NeNA and the mean
    event length equal, as phases 13-14 hold the histogram and the
    chains; the drift within DRIFT_AGREE, as phase 7); then a summary
    row of those values (localize._summary) through
    localize._save_file_summary into a database in a temporary directory,
    read back with sqlite3: the declared types pandas' to_sql gives and
    the values. Returns (launches, walls)."""
    import sqlite3

    import torch

    from picasso_torch import localize

    checks = {
        "nena": lambda d: localize.check_nena(locs, info, device=d),
        "kinetics": lambda d: localize.check_kinetics(locs, info, device=d),
        "drift": lambda d: localize.check_drift(locs, info, device=d),
    }
    card, cpu, walls = {}, {}, {}

    def on_card():
        for name, fn in checks.items():
            t0 = time.perf_counter()
            card[name] = fn("cuda")
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0

    _, _, launches = counted(on_card)
    for name, fn in checks.items():
        t0 = time.perf_counter()
        cpu[name] = fn("cpu")
        walls[name + " cpu"] = time.perf_counter() - t0
    d_drift = float(np.abs(np.subtract(card["drift"], cpu["drift"])).max())
    if (card["nena"] != cpu["nena"] or card["kinetics"] != cpu["kinetics"]
            or d_drift > DRIFT_AGREE or not np.isfinite(card["nena"])):
        raise AssertionError(f"-db checks: card {card} against the CPU {cpu}")
    if ({k: v for k, v in launches.items() if v}
            != {"link walk": 1, "apply_drift records": 1}):
        raise AssertionError(f"-db checks launched {launches}")
    with tempfile.TemporaryDirectory(prefix=".smoke-db-", dir=ROOT) as tmp:
        movie_file = os.path.join(tmp, "movie.raw")
        open(movie_file, "wb").close()
        db = os.path.join(tmp, "app_0410.db")
        summary = localize._summary(
            locs, info, movie_file, os.path.join(tmp, "movie_locs.hdf5"),
            drift=card["drift"], len_mean=card["kinetics"],
            nena=card["nena"], device="cuda")
        keep = localize._db_filename
        localize._db_filename = lambda: db
        try:
            localize._save_file_summary(summary)
        finally:
            localize._db_filename = keep
        con = sqlite3.connect(db)
        try:
            types = {r[1]: r[2] for r in con.execute(
                'PRAGMA table_info("files")')}
            row = con.execute('SELECT "n_locs", "nena_px", "len_mean", '
                              '"z_mean" FROM "files"').fetchall()
        finally:
            con.close()
    want = {"x_mean": "REAL", "n_locs": "INTEGER", "frames": "INTEGER",
            "pixelsize": "TEXT", "nena_nm": "TEXT", "z_mean": "TEXT",
            "filename": "TEXT", "file_created": "TIMESTAMP",
            "entry_created": "TIMESTAMP"}
    if (list(types) != list(summary) or any(types[k] != v for k, v in
                                            want.items())
            or row != [(len(locs), card["nena"], card["kinetics"], None)]):
        raise AssertionError(f"-db row: {types} {row}")
    print(f"-db checks ({smi}) on {len(locs)} undrifted locs, card (CPU) "
          f"s: NeNA {walls['nena']:.3f} ({walls['nena cpu']:.3f}), "
          f"kinetics {walls['kinetics']:.3f} ({walls['kinetics cpu']:.3f}), "
          f"drift in {info[0]['Frames'] // 10}-frame segments "
          f"{walls['drift']:.3f} ({walls['drift cpu']:.3f}); NeNA "
          f"{card['nena']:.5f} px and mean length {card['kinetics']:.4f} "
          f"frames == the CPU, mean drift {card['drift']} (card - CPU max "
          f"{d_drift:.3g} px); launches {launches}; files row of "
          f"{len(types)} columns read back with its declared types")
    return launches, walls


ALIGN_OFFSET = (0.37, -0.21)  # px, (x, y) of the second channel


def align_phase(locs, info, sites, smi: str):
    """16. align_rcc on the card: two channels, the undrifted MLE locs
    and a copy moved by ALIGN_OFFSET, each run on the card and on the
    CPU (card vs CPU within DRIFT_AGREE). make_bench_movie puts every
    site on an integer pixel, where the oversampling-1 render that RCC
    correlates bins a site's locs at a fixed phase and cannot resolve a
    sub-pixel offset (the reference's algorithm, on the CPU too), so the
    gated run first moves each site's locs by a random sub-pixel
    amount (the same in both channels) off that lattice: its offset left
    (the mean of channel 2 - channel 1) under DRIFT_RESID; the run on
    the lattice is reported. Returns the walls."""
    import torch
    from scipy.spatial import cKDTree

    from picasso_torch import postprocess

    _, near = cKDTree(sites[:, ::-1].astype(np.float64)).query(
        np.column_stack([locs["x"], locs["y"]]))
    dither = np.random.default_rng(16).uniform(0, 1, (len(sites), 2))
    off_lattice = locs.copy()
    off_lattice["x"] += dither[near, 0]
    off_lattice["y"] += dither[near, 1]
    walls, resid = {}, {}
    for what, base in (("off the lattice", off_lattice),
                       ("on the lattice", locs)):
        moved = base.copy()
        moved["x"] += ALIGN_OFFSET[0]
        moved["y"] += ALIGN_OFFSET[1]
        channels, infos = [base, moved], [info, info]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card, (hx, hy) = postprocess.align_rcc(
            channels, infos, return_shifts=True, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = postprocess.align_rcc(channels, infos, device="cpu")
        walls[what] = t1 - t0
        walls[what + " cpu"] = time.perf_counter() - t1
        resid[what] = {c: float(np.mean(card[1][c] - card[0][c]))
                       for c in ("x", "y")}
        agree = max(float(np.abs(a[c] - b[c]).max())
                    for a, b in zip(card, cpu) for c in ("x", "y"))
        print(f"align_rcc {what} ({smi}): 2 channels of {len(locs)} locs, "
              f"offset {ALIGN_OFFSET} px: card {walls[what]:.3f} s, CPU "
              f"{walls[what + ' cpu']:.3f} s, {len(hx)} passes (mean shifts "
              f"x {[round(float(v), 5) for v in hx]}, y "
              f"{[round(float(v), 5) for v in hy]}); offset left x "
              f"{resid[what]['x']:.5f} y {resid[what]['y']:.5f} px; card vs "
              f"CPU max |d| {agree:.3g} px")
        if agree > DRIFT_AGREE:
            raise AssertionError(f"align_rcc {what}: card vs CPU {agree} px")
    if max(map(abs, resid["off the lattice"].values())) > DRIFT_RESID:
        raise AssertionError(f"align_rcc: offset left {resid}")
    return walls


def _window(locs, window):
    x0, y0, side = window
    return locs[(locs["x"] >= x0) & (locs["x"] < x0 + side)
                & (locs["y"] >= y0) & (locs["y"] < y0 + side)]


def cluster_phase(locs, info, locs3d, info3d, sites, counted, smi: str):
    """17. clustering on the card. The main path through the entry
    points with every count set to 0 just before (the host sweep of
    csrc/cluster_sweep.cu launched once a SMLM run, no kernel): the SMLM
    clusterer with frame analysis on ``locs`` (2D) and its centers, on
    ``locs3d`` (3D, radius_z RADIUS_Z_LPZ x their median lpz), DBSCAN on
    ``locs``, HDBSCAN on their WINDOW_32; then the SMLM 2D run split into
    its passes (with the pairs the cells offered), DBSCAN's passes and
    HDBSCAN's parts, and the RMS radius of the locs around their site's
    mean (``sites``: the movie's, (row, column)); then on WINDOW_64
    (HDBSCAN: WINDOW_32) the card against the CPU: labels and clustered
    tables equal, centers within CENTERS_ULPS. Returns (launches,
    walls)."""
    import torch
    from scipy.spatial import cKDTree

    from picasso_torch import clusterer
    from picasso_torch.ops import cluster as cluster_ops
    from picasso_torch.ops import neighbors
    from torch_parity import CENTERS_ULPS, compare_tables_ulps

    px = info3d[0]["Pixelsize"]
    lpz = float(np.nanmedian(locs3d["lpz"]))
    radius_z = round(RADIUS_Z_LPZ * lpz / px, 3)
    win32 = _window(locs, WINDOW_32)
    walls, out = {}, {}
    sync = torch.cuda.synchronize

    def step(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        sync()
        walls[name] = time.perf_counter() - t0

    def main_path():
        step("smlm 2d", lambda: clusterer.cluster(
            locs, CLUSTER_R, CLUSTER_MIN, True, return_info=True,
            device="cuda"))
        step("centers", lambda: clusterer.find_cluster_centers(
            out["smlm 2d"][0], device="cuda"))
        step("smlm 3d", lambda: clusterer.cluster(
            locs3d, CLUSTER_R, CLUSTER_MIN, True, radius_z=radius_z,
            pixelsize=px, return_info=True, device="cuda"))
        step("dbscan", lambda: clusterer.dbscan(
            locs, CLUSTER_R, CLUSTER_MIN, return_info=True, device="cuda"))
        step("hdbscan", lambda: clusterer.hdbscan(
            win32, HDBSCAN_MIN, HDBSCAN_MIN, return_info=True,
            device="cuda"))

    _, wall, launches = counted(main_path)
    if launches["cluster sweep"] != 2 or any(
            v for k, v in launches.items() if k != "cluster sweep"):
        raise AssertionError(f"clustering launched {launches}")
    c2d, i2d = out["smlm 2d"]
    centers = out["centers"]
    c3d, i3d = out["smlm 3d"]
    dbs, idb = out["dbscan"]
    hdb, ihd = out["hdbscan"]
    for what, cl, inf in (("SMLM 2D", c2d, i2d), ("SMLM 3D", c3d, i3d),
                          ("DBSCAN", dbs, idb), ("HDBSCAN", hdb, ihd)):
        if not (len(cl) and inf["Number of clusters"] > 0
                and np.isfinite(cl["x"]).all()):
            raise AssertionError(f"{what}: no clusters ({inf})")
    if len(centers) != i2d["Number of clusters"] or not (
            np.isfinite(centers["x"]).all() and (centers["n_locs"]
                                                 >= CLUSTER_MIN).all()):
        raise AssertionError("cluster centers: not one finite row a cluster")
    # the SMLM 2D run split into its passes on the card
    X = torch.from_numpy(np.column_stack([locs["x"], locs["y"]]).astype(
        np.float32)).cuda()
    split = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        split[name] = time.perf_counter() - t0
        return r

    n_pairs = timed("cells", lambda: sum(
        len(i) for i, _ in neighbors.pairs(X, CLUSTER_R)))
    counts = timed("counts", lambda: neighbors.cluster_counts(X, CLUSTER_R))
    max_nb = timed("max", lambda: neighbors.radius_max(X, CLUSTER_R, counts))
    lm = torch.nonzero((counts > CLUSTER_MIN) & (counts == max_nb))[:, 0]
    csr = timed("lists", lambda: neighbors.neighbour_lists(X, CLUSTER_R, lm))
    timed("sweep", lambda: cluster_ops.sweep(lm, *csr, len(X)))
    Xd = torch.from_numpy(np.column_stack([locs["x"], locs["y"]]).astype(
        np.float64)).cuda()
    _, passes = timed("dbscan", lambda: cluster_ops.dbscan_labels(
        Xd, CLUSTER_R, CLUSTER_MIN))
    # how the locs spread around their site, and the sites that hold
    # more than one cluster, against the clusters at larger radii
    xy = np.column_stack([locs["x"], locs["y"]]).astype(np.float64)
    sites_xy = np.unique(sites, axis=0)[:, ::-1].astype(np.float64)
    tree = cKDTree(sites_xy)
    near = tree.query(xy)[1]
    dev2 = np.zeros(len(xy))
    for c in range(2):
        mean = (np.bincount(near, xy[:, c], len(sites_xy))
                / np.maximum(np.bincount(near, minlength=len(sites_xy)), 1))
        dev2 += (xy[:, c] - mean[near]) ** 2
    spread = np.percentile(np.sqrt(dev2), [50, 90, 99])
    per_site = np.bincount(tree.query(np.column_stack(
        [centers["x"], centers["y"]]))[1], minlength=len(sites_xy))
    wider = {r: clusterer.cluster(locs, r, CLUSTER_MIN, True, return_info=True,
                                  device="cuda")[1]["Number of clusters"]
             for r in (2 * CLUSTER_R, 4 * CLUSTER_R)}
    hparts = {}
    Xh = np.column_stack([win32["x"], win32["y"]])
    clusterer._hdbscan(Xh, HDBSCAN_MIN, HDBSCAN_MIN, device="cuda",
                       walls=hparts)
    print(f"clustering ({smi}): main path {wall:.3f} s, launches {launches}")
    print(f"  SMLM 2D: {len(locs)} locs, r {CLUSTER_R} px, min. locs "
          f"{CLUSTER_MIN}, frame analysis: {i2d['Number of clusters']} "
          f"clusters against {len(sites_xy)} sites ({np.sum(per_site > 1)} "
          f"sites hold more than one; the locs' distance to their site's "
          f"mean, percentiles 50/90/99: {spread.round(4).tolist()} px; at "
          f"r {list(wider)} px {list(wider.values())} clusters), "
          f"{len(c2d)} locs clustered "
          f"({i2d['Fraction of rejected locs (%)']:.2f}% rejected), "
          f"{len(lm)} local maxima, {n_pairs} pairs tested: card "
          f"{walls['smlm 2d']:.3f} s (split: cells alone "
          f"{split['cells']:.3f}, counts {split['counts']:.3f}, max "
          f"{split['max']:.3f}, maxima's lists {split['lists']:.3f} "
          f"({int(csr[2].numel())} neighbours), sweep with readback "
          f"{split['sweep']:.3f} s); find_cluster_centers "
          f"{walls['centers']:.3f} s")
    print(f"  SMLM 3D: {len(locs3d)} locs, radius_z {radius_z} px ("
          f"{RADIUS_Z_LPZ} x the median lpz {lpz:.2f} nm / {px} nm): "
          f"{i3d['Number of clusters']} clusters, {len(c3d)} locs: card "
          f"{walls['smlm 3d']:.3f} s")
    print(f"  DBSCAN: r {CLUSTER_R} px, min. density {CLUSTER_MIN}: "
          f"{idb['Number of clusters']} clusters, {len(dbs)} locs: card "
          f"{walls['dbscan']:.3f} s; {passes} passes of the components to "
          f"their fixed point (labels alone {split['dbscan']:.3f} s)")
    print(f"  HDBSCAN: {len(win32)} locs of the {WINDOW_32} window, min. "
          f"cluster size and samples {HDBSCAN_MIN}: "
          f"{ihd['Number of clusters']} clusters, {len(hdb)} locs: card "
          f"{walls['hdbscan']:.3f} s (again, split: core distances "
          f"{hparts['core']:.3f}, Prim {hparts['prim']:.3f}, host tree "
          f"{hparts['tree']:.3f} s)")
    # the card against the CPU on the windows
    w64, w64_3d = _window(locs, WINDOW_64), _window(locs3d, WINDOW_64)
    checks = {
        "SMLM 2D": lambda d: clusterer.cluster(w64, CLUSTER_R, CLUSTER_MIN,
                                               True, device=d),
        "SMLM 3D": lambda d: clusterer.cluster(
            w64_3d, CLUSTER_R, CLUSTER_MIN, True, radius_z=radius_z,
            pixelsize=px, device=d),
        "DBSCAN": lambda d: clusterer.dbscan(w64, CLUSTER_R, CLUSTER_MIN,
                                             device=d),
        "HDBSCAN": lambda d: clusterer.hdbscan(win32, HDBSCAN_MIN,
                                               HDBSCAN_MIN, device=d),
    }
    cmp = {}
    for what, fn in checks.items():
        if what == "HDBSCAN":  # the card's run is the main path's
            card, t_card = hdb, walls["hdbscan"]
        else:
            t0 = time.perf_counter()
            card = fn("cuda")
            sync()
            t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = fn("cpu")
        t_cpu = time.perf_counter() - t0
        if card.dtype != cpu.dtype or not all(
                np.array_equal(card[n], cpu[n]) for n in card.dtype.names):
            raise AssertionError(f"{what}: the card's clustered locs differ "
                                 "from the CPU's")
        cmp[what] = (len(card), len(np.unique(card["group"])), t_card, t_cpu)
        if what == "SMLM 2D":
            t0 = time.perf_counter()
            ctr = clusterer.find_cluster_centers(card, device="cuda")
            sync()
            t1 = time.perf_counter()
            ctr_cpu = clusterer.find_cluster_centers(card, device="cpu")
            t2 = time.perf_counter()
            differ = compare_tables_ulps(ctr, ctr_cpu, CENTERS_ULPS,
                                         "cluster centers card vs CPU")
            cmp["centers"] = (len(ctr), differ, t1 - t0, t2 - t1)
    print(f"  card == CPU ({smi}): " + "; ".join(
        f"{k} {v[0]} locs in {v[1]} clusters, card {v[2]:.3f} s, CPU "
        f"{v[3]:.3f} s" for k, v in cmp.items() if k != "centers")
        + f" (SMLM and DBSCAN on {len(w64)} / {len(w64_3d)} (3D) locs of "
        f"the {WINDOW_64} window, HDBSCAN on the {WINDOW_32} one); centers "
        f"of {cmp['centers'][0]} clusters within {CENTERS_ULPS} ulps "
        f"({cmp['centers'][1]} float cells differ), card "
        f"{cmp['centers'][2]:.3f} s, CPU {cmp['centers'][3]:.3f} s")
    walls.update({"split " + k: v for k, v in split.items()})
    walls.update({"hdbscan " + k: v for k, v in hparts.items()})
    return launches, walls


def _step_kernels(fn) -> tuple[int | None, int]:
    """(the CUDA kernels one call of ``fn`` launches, by torch.profiler,
    None where it records no device event; the aten ops it dispatches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.n += 1
            return func(*args, **(kwargs or {}))

    torch.cuda.synchronize()
    with Ops():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return (kernels or None), Ops.n


def origami_phase(counted, smi: str):
    """18. the analyses of grouped locs on the card: DBSCAN of N_ORIGAMI
    origami, G5M and averaging through the entry points, each counted
    from 0 (no kernel may launch), held to the truth, the walls split;
    then card == CPU on N_CARD_CPU origami. Returns (launches of G5M,
    launches of averaging)."""
    import torch
    from scipy.spatial import cKDTree

    from picasso_torch import average, clusterer, g5m, lib
    from picasso_torch.ops import gmm
    from torch_data import make_origami_locs, rigid_rotations, rotation_share
    from torch_parity import G5M_BIC_TIE, G5M_SAME_ULPS, compare_g5m

    t0 = time.perf_counter()
    locs, info, truth = make_origami_locs(N_ORIGAMI, ORIGAMI_SEED)
    t_make = time.perf_counter() - t0
    (clustered, cinfo), wall_db, launches_db = counted(
        lambda: clusterer.dbscan(locs, ORIGAMI_R, ORIGAMI_DENSITY,
                                 return_info=True, device="cuda"))
    ids, rows = lib.group_rows(clustered["group"])
    means = np.array([[clustered["x"][r].mean(), clustered["y"][r].mean()]
                      for r in rows])
    dist, origami = cKDTree(truth["centers"]).query(means)
    if not (len(ids) == N_ORIGAMI and len(np.unique(origami)) == N_ORIGAMI
            and dist.max() < 0.1):
        raise AssertionError(f"DBSCAN: {len(ids)} clusters for {N_ORIGAMI} "
                             f"origami ({len(np.unique(origami))} hit)")
    rec = {}
    (centers, g5m_locs, g5m_info), wall_g5m, launches_g5m = counted(
        lambda: g5m.g5m(clustered, info, device="cuda", record=rec))
    avg_walls = []
    averaged, wall_avg, launches_avg = counted(
        lambda: average.average(clustered, info,
                                display_pixel_size=AVG_PX,
                                iterations=AVG_IT, device="cuda",
                                walls=avg_walls))
    for what, launches in (("DBSCAN", launches_db), ("G5M", launches_g5m),
                           ("averaging", launches_avg)):
        if any(launches.values()):
            raise AssertionError(f"{what} launched {launches}")
    # G5M against the truth
    sites = truth["sites"].reshape(-1, 2)
    xy = np.column_stack([centers["x"], centers["y"]]).astype(np.float64)
    if not (np.isfinite(xy).all() and len(xy)):
        raise AssertionError("G5M: no finite centers")
    found = float(np.mean(cKDTree(xy).query(sites)[0] < G5M_PX))
    true_c = float(np.mean(cKDTree(sites).query(xy)[0] < G5M_PX))
    per = np.bincount(centers["group_input"], minlength=int(ids.max()) + 1)[
        ids]
    k_fit = np.bincount([f[0] for f in rec["fit"].values()])
    em_s = sum(rec["em"].values())
    kernels, ops, step_ms, step_bound, step_rows = _step_kernels_of_origami(
        clustered, info, gmm, g5m, _step_kernels)
    print(f"origami ({smi}): {N_ORIGAMI} origami, {len(locs)} locs (made "
          f"in {t_make:.2f} s); DBSCAN r {ORIGAMI_R} px, density "
          f"{ORIGAMI_DENSITY}: {len(ids)} clusters, one an origami, "
          f"{len(clustered)} locs, card {wall_db:.3f} s")
    buckets = {b: len(ix) for b, ix in sorted(g5m._buckets(
        [len(r) for r in rows]).items())}
    print(f"  G5M (batched; origami a size bucket {buckets}): "
          f"{len(centers)} molecules after the postprocess filter, "
          f"molecules an origami {np.bincount(per).tolist()} (index: count); "
          f"true sites within {G5M_PX} px of a center {found:.4f}, centers "
          f"within {G5M_PX} px of a site {true_c:.4f}; K of the fits "
          f"{k_fit.tolist()} (index: K), K reached {max(rec['em'])}")
    print(f"  G5M walls: total {wall_g5m:.3f} s = EM {em_s:.3f} s (per K: "
          + json.dumps({k: round(v, 4) for k, v in rec["em"].items()})
          + f") + BIC readbacks {rec['bic']:.3f} s + host tables "
          f"{rec['convert']:.3f} s + host-route fallbacks {rec['host']:.3f} "
          f"s ({rec['host_clusters']} clusters) + the rest; "
          f"{rec['steps']} E+M steps on {rec['row_steps']} rows, "
          f"{1e6 * em_s / rec['steps']:.1f} us of EM wall a step; one E+M "
          f"step (K 11, {step_rows} rows of 512): {kernels} kernels "
          f"(torch.profiler), {ops} aten ops, {step_ms:.4f} ms (median of 5"
          f" CUDA-event runs; bound {step_bound[0]:.4f} ms, "
          f"{step_bound[1]})")
    # averaging against the truth
    a_step = average._workspace(average.com_align(clustered), info,
                                AVG_PX)[3][1]
    rec_rot = rigid_rotations(clustered, averaged, rows)
    share, share_pi, consensus = rotation_share(
        rec_rot, truth["angles"][origami], 2 * a_step)
    print(f"  averaging: {len(ids)} groups, {AVG_IT} iterations at {AVG_PX} "
          f"nm (angle step {a_step:.4f} rad): card {wall_avg:.3f} s, per "
          "iteration " + json.dumps([{k: round(v, 4) for k, v in w.items()}
                                     for w in avg_walls])
          + f"; rotations within 2 steps of the truth {share:.4f}, or of "
          f"its turn by pi {share_pi:.4f} (consensus {consensus:.4f} rad)")
    if found < G5M_SITES or true_c < G5M_CENTERS:
        raise AssertionError(f"G5M: sites found {found}, centers true "
                             f"{true_c} against {G5M_SITES}, {G5M_CENTERS}")
    if share < ROT_SHARE or share_pi < ROT_SHARE_PI:
        raise AssertionError(f"averaging: rotation shares {share}, "
                             f"{share_pi} against {ROT_SHARE}, "
                             f"{ROT_SHARE_PI}")
    # the card against the CPU on the first N_CARD_CPU origami
    sub = clustered[np.isin(clustered["group"], ids[:N_CARD_CPU])]
    runs = {}
    for dev in ("cuda", "cpu"):
        r = {}
        t1 = time.perf_counter()
        out = g5m.g5m(sub, info, postprocess=False, device=dev, record=r)
        torch.cuda.synchronize()
        runs[dev] = out[0], r, time.perf_counter() - t1
    (cc, rc, tc), (cp, rp, tp) = runs["cuda"], runs["cpu"]
    agree = compare_g5m(cc, rc, cp, rp, sub, what="G5M card vs CPU")
    print(f"  G5M card == CPU ({smi}) on {N_CARD_CPU} origami "
          f"({len(sub)} locs, no postprocess filter): card {tc:.3f} s, CPU "
          f"{tp:.3f} s ({len(cc)} / {len(cp)} molecules); BIC near ties "
          f"(within {G5M_BIC_TIE}) {agree['bic_ties']}; clusters fit with "
          f"the same K, start and steps: centers at most "
          f"{agree['worst_same']:.3e} px apart (bound {agree['same_px']:.3e}"
          f" px, {G5M_SAME_ULPS} f32 ulps); with another start or step count"
          f" at an EM near tie (K, start, steps card / CPU, px): "
          f"{agree['stepped']}; n_locs a half apart {agree['n_locs_half']}")
    # averaging: the first iteration's picks from the same inputs
    sub_c = average.com_align(sub)
    x, y, grows, angles, ov, t_min, t_max = average._workspace(sub_c, info,
                                                               AVG_PX)
    _, image = average._render_hist_square(x, y, ov, t_min, t_max)
    picks, aligned = {}, {}
    for dev in ("cuda", "cpu"):
        picks[dev] = []
        aligned[dev] = average._align_groups_device(
            x.copy(), y.copy(), grows, angles, ov, t_min, t_max, image,
            image.shape[0] / 2, dev, picks=picks[dev])
    (bc, vc, sc), (bp, vp, sp) = ((np.concatenate(p) for p in zip(*picks[d]))
                                  for d in ("cuda", "cpu"))
    differ = np.nonzero(bc != bp)[0]
    for g in differ:
        if not (vc[g] - sc[g] <= PICK_TIE * abs(vc[g])
                or vp[g] - sp[g] <= PICK_TIE * abs(vp[g])):
            raise AssertionError(f"averaging card vs CPU: group {g} picks "
                                 f"{bc[g]} / {bp[g]}, not a near tie")
    full = {}
    for dev in ("cuda", "cpu"):
        t1 = time.perf_counter()
        full[dev] = average.average(sub, info, display_pixel_size=AVG_PX,
                                    iterations=AVG_IT, device=dev)
        full[dev + " s"] = time.perf_counter() - t1
    dxy = max(np.abs(full["cuda"][c] - full["cpu"][c]).max()
              for c in ("x", "y"))
    print(f"  averaging card == CPU on {N_CARD_CPU} origami: first "
          f"iteration picks differ in {len(differ)} of {len(grows)} groups "
          f"(each a near tie within {PICK_TIE}); after {AVG_IT} iterations "
          f"the largest x/y difference {dxy:.3e} px; card "
          f"{full['cuda s']:.3f} s, CPU {full['cpu s']:.3f} s")
    return launches_g5m, launches_avg, (clustered, info, ids)


def _spinna_bound(scorer, rows) -> tuple[float, str, float]:
    """The batched scorer's least time (ms) for the candidates ``rows``:
    the distances between the points each candidate keeps (N_sim x
    kept_1 x kept_2 a target pair, from BatchedScorer.kept_counts) at 3 D
    operations each over the f32 peak, or those points (coordinates and a
    mask) read once and the scores written over the memory rate; and the
    ms of the bytes its distance tiles move as the package forms them, at
    each chunk's width (per axis a difference written, squared in place
    and summed, then k min-extractions read: 24 D - 12 + 4 k B a pair)."""
    kept = scorer.kept_counts(rows).astype(np.float64)
    pairs = tiles = 0.0
    for i1, i2, k in scorer.pair_keys:
        pairs += scorer.N_sim * float(np.sum(kept[:, i1] * kept[:, i2]))
        for s in range(0, len(rows), scorer.chunk):
            w = np.maximum(kept[s:s + scorer.chunk].max(0), 1)
            tiles += (len(kept[s:s + scorer.chunk]) * scorer.N_sim * w[i1]
                      * w[i2] * (24 * scorer.dim - 12 + 4 * k))
    inputs = scorer.N_sim * kept.sum() * (4 * scorer.dim + 1) + 8 * len(rows)
    b_ms, by = _bound(3.0 * scorer.dim * pairs, inputs)
    return b_ms, by, tiles / PEAK_BYTES * 1e3


def _pct(props) -> list:
    return np.round(np.asarray(props, np.float64), 2).tolist()


def _chunk_split(scorer, rows) -> dict:
    """One chunk of the scorer split by CUDA events: simulate, kNN, KS
    (ms, medians of 3 after a warm-up)."""
    import torch

    times = {"simulate": [], "kNN": [], "KS": []}
    width = np.maximum(scorer.kept_counts(rows).max(0), 1)  # as score()
    for rep in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        coords, masks = scorer.simulate(rows, 7, 0, width)
        ev[1].record()
        knn, eff = scorer.knn_pairs(coords, masks)
        ev[2].record()
        scorer.ks_scores(knn, eff, len(rows))
        ev[3].record()
        torch.cuda.synchronize()
        if rep:
            for i, k in enumerate(times):
                times[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: statistics.median(v) for k, v in times.items()}


def spinna_phase(counted, smi: str):
    """19. SPINNA on the card through the API (no kernel; plain torch):
    (a) the cell-scale field, brute force and coarse-to-fine, the scorer's
    chunks, pads, peak memory, a chunk's split and its bound; (b)
    bench.py's recipe: candidates/s after a warm call, fit_bayesian at its
    defaults with the bootstrap; (c) card == CPU. Returns the launches of
    every kernel over the phase's fits."""
    import torch

    from picasso_torch import spinna
    from torch_data import SPINNA_CELL, spinna_cell
    from torch_parity import (
        SPINNA_KS_STEPS, compare_spinna_scores, spinna_sample_sizes,
    )

    launches = {}

    def run(fn):
        out, wall, n = counted(fn)
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        return out, wall

    # (a) the cell-scale field
    mixer, gt = spinna_cell(spinna)
    n_obs = len(gt["A"])
    rows = mixer.convert_N_structures_to_array(spinna.generate_N_structures(
        mixer.structures, {"A": sum(c * n for c, n in zip(
            SPINNA_CELL["counts"], (1, 2, 3)))}, SPINNA_GRANULARITY))
    truth = mixer.convert_counts_to_props(np.array(SPINNA_CELL["counts"]))
    sp = spinna.SPINNA(mixer, gt, N_sim=SPINNA_NSIM, device="cuda")
    sp.NN_scorer(rows[:4])  # the first launches of each torch op
    scorer = sp._get_batched_scorer(rows)
    torch.cuda.reset_peak_memory_stats()
    np.random.seed(20)
    (props_bf, score_bf, scores_bf), wall_bf = run(
        lambda: sp.fit_stoichiometry(rows, fitting_mode="brute-force",
                                     return_scores=True))
    peak = torch.cuda.max_memory_allocated() / 2**30
    np.random.seed(21)
    (props_cf, score_cf, scores_cf), wall_cf = run(
        lambda: sp.fit_stoichiometry(rows, fitting_mode="coarse-to-fine",
                                     return_scores=True))
    split = _chunk_split(scorer, rows[:scorer.chunk])
    b_ms, b_by, tile_ms = _spinna_bound(scorer, rows)
    cb_ms, cb_by, ctile_ms = _spinna_bound(scorer, rows[:scorer.chunk])
    n_chunks = -(-len(rows) // scorer.chunk)
    print(f"SPINNA ({smi}) (a) cell-scale field: {n_obs} observed A of "
          f"5000 in {SPINNA_CELL['side'] / 1000:.0f} x "
          f"{SPINNA_CELL['side'] / 1000:.0f} um, truth "
          f"{_pct(truth)} %, {len(rows)} candidates, N_sim "
          f"{SPINNA_NSIM}; brute force {wall_bf:.3f} s = "
          f"{len(rows) / wall_bf:.1f} candidates/s, best "
          f"{_pct(props_bf)} % (KS {score_bf:.4f}); coarse-to-fine "
          f"{wall_cf:.3f} s over {len(scores_cf)} fine candidates, best "
          f"{_pct(props_cf)} % (KS {score_cf:.4f})")
    print(f"  scorer ({smi}): chunk {scorer.chunk} candidates, {n_chunks} "
          f"chunks, pads N_pad {scorer.N_pad} P {scorer.P} (a chunk's width"
          f" its largest kept count, {int(scorer.kept_counts(rows).max())} "
          f"at most), kNN block "
          f"{scorer.block}; peak memory {peak:.2f} GiB; one chunk "
          f"(CUDA events): simulate {split['simulate']:.2f} ms, kNN "
          f"{split['kNN']:.2f} ms, KS {split['KS']:.2f} ms (bound "
          f"{cb_ms:.3f} ms by {cb_by}, its tiles' bytes {ctile_ms:.2f} ms); "
          f"all {len(rows)}: bound {b_ms:.3f} ms by {b_by}, tiles' bytes "
          f"{tile_ms:.2f} ms")
    if np.abs(props_bf - truth).max() > SPINNA_POINTS:
        raise AssertionError(f"SPINNA (a): brute force {props_bf} against "
                             f"{truth}")
    # (b) bench.py's recipe
    monomer = spinna.Structure("monomer")
    monomer.define_coordinates("A", [0.0], [0.0], [0.0])
    dimer = spinna.Structure("dimer")
    dimer.define_coordinates("A", [-10.0, 10.0], [0.0, 0.0], [0.0, 0.0])
    bmixer = spinna.StructureMixer([monomer, dimer], label_unc={"A": 2.0},
                                   le={"A": 0.9}, width=4000.0, height=4000.0)
    np.random.seed(0)
    bgt = bmixer.run_simulation([300, 250])
    bsp = spinna.SPINNA(bmixer, bgt, N_sim=4, device="cuda")
    N = np.array([[a * 16, b * 14] for a in range(33) for b in range(33)])
    bsp.NN_scorer(N)  # warm
    (_, bscores), wall_b = run(lambda: bsp.NN_scorer(N))
    bprops = bmixer.convert_counts_to_props(N[int(np.argmin(bscores))])
    np.random.seed(22)
    ((bay_props, bay_sem), (bay_score, bay_ssem)), wall_bay = run(
        lambda: bsp.fit_bayesian(N, bootstrap=True))
    bscorer = bsp._get_batched_scorer(N)
    bb_ms, bb_by, btile_ms = _spinna_bound(bscorer, N)
    print(f"  (b) bench.py's recipe ({smi}): {len(N)} candidates, N_sim 4: "
          f"{wall_b:.3f} s = {len(N) / wall_b:.1f} candidates/s (chunk "
          f"{bscorer.chunk}, P {bscorer.P}; bound {bb_ms:.3f} ms by {bb_by},"
          f" tiles' bytes {btile_ms:.2f} ms); best monomer share "
          f"{bprops[0]:.2f} % (truth 37.5); fit_bayesian (20 + 80) with the "
          f"bootstrap {wall_bay:.3f} s: {_pct(bay_props)} % +- "
          f"{_pct(bay_sem)}, KS {bay_score:.4f} +- "
          f"{bay_ssem:.4f}")
    if not (np.isfinite(bscores).all() and np.isfinite(scores_bf).all()
            and np.isfinite(bay_score)):
        raise AssertionError("SPINNA (b): non-finite scores")
    if abs(bprops[0] - 37.5) > SPINNA_BENCH_POINTS:
        raise AssertionError(f"SPINNA (b): monomer share {bprops[0]}")
    # (c) the card against the CPU
    for what, (m, g), sub in (
            ("field", (mixer, gt), rows[::29][:N_SPINNA_CARD_CPU]),
            ("3D tenth", spinna_cell(spinna, 0.1, depth=500.0,
                                     random_rot_mode="3D"), None)):
        space = rows if sub is not None else m.convert_N_structures_to_array(
            spinna.generate_N_structures(m.structures, {"A": 500}, 21))
        sub = space[::29][:N_SPINNA_CARD_CPU] if sub is None else sub
        res = {}
        for d in ("cuda", "cpu"):
            s1 = spinna.SPINNA(m, g, N_sim=1, device=d)
            sc = s1._get_batched_scorer(space)
            t1 = time.perf_counter()
            res[d] = sc.score(sub, seed=23)
            res[d + " s"] = time.perf_counter() - t1
        n1 = spinna_sample_sizes(sc, sc.simulate(sub, 23)[1])
        agree = compare_spinna_scores(res["cuda"], res["cpu"], n1,
                                      f"SPINNA card vs CPU ({what})")
        print(f"  (c) card == CPU ({smi}), {what}, {len(sub)} candidates, "
              f"N_sim 1: largest difference {agree['max_abs']:.3e} "
              f"({agree['max_steps']:.2f} ECDF steps, bound "
              f"{SPINNA_KS_STEPS} / n1), equal bit for bit "
              f"{agree['equal']:.3f}; card {res['cuda s']:.3f} s, CPU "
              f"{res['cpu s']:.3f} s")
    if any(launches.values()):
        raise AssertionError(f"SPINNA launched {launches}")
    return launches


def _step_kernels_of_origami(clustered, info, gmm, g5m, kernels_in):
    """One E+M step (ops/gmm._step) at K 11 on every cluster of
    ``clustered`` of at most 512 locs, padded to 512, one start: (its
    kernels, its aten ops, its ms, its bound (ms, by), the rows)."""
    import torch

    from picasso_torch import lib

    _, rows = lib.group_rows(clustered["group"])
    preps = [g5m._prep_group(clustered[r], min_locs=10, pixelsize=info[0][
        "Pixelsize"], max_locs_per_cluster=np.inf, loc_prec_handle="local")
        for r in rows]
    preps = [p for p in preps if len(p[0]) <= 512]
    X, mask, lp = (torch.from_numpy(a).cuda() for a in gmm.pad_clusters(
        [p[0] for p in preps], [p[1] for p in preps], 512))
    u = torch.from_numpy(np.random.default_rng(0).random((len(X), 11))).cuda()
    bounds = tuple(torch.tensor(b, device="cuda") for b in (0.8, 1.5))
    centers = gmm._kmeanspp(X, mask, u)
    d2 = gmm._sqsum(X[:, :, None, :] - centers[:, None, :, :])
    one_hot = torch.nn.functional.one_hot(d2.argmin(2), 11).float()
    params = gmm._m_step(X, mask, torch.log(one_hot), lp, bounds, True, True)
    R = len(X)
    state = (params, torch.full((R,), -torch.inf, device="cuda"),
             torch.zeros(R, dtype=torch.bool, device="cuda"),
             torch.zeros(R, dtype=torch.int32, device="cuda"))

    def step():
        return gmm._step(X, mask, lp, bounds, True, True, *state)

    kernels, ops = kernels_in(step)
    # the step's least time: its inputs (X, mask, lp) read once, and ~30
    # operations a (row, point, component) (E: the distances, the log
    # density, the log-sum-exp; M: the sums of the responsibilities, the
    # means, the variances and the local precisions)
    bound = _bound(30.0 * R * 512 * 11, R * 512 * (4 * 2 + 1 + 4))
    return kernels, ops, _median_ms(step), bound, R


def _sum_launches(*runs) -> dict:
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def _equal_arrays(a: list, b: list, what: str) -> None:
    """Equal bit for bit, NaN where NaN, array by array (a structured
    array field by field, its dtype too)."""
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} outputs against {len(b)}")
    for k, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        names = x.dtype.names
        if names:
            if x.dtype != y.dtype:
                raise AssertionError(f"{what}: dtypes {x.dtype}, {y.dtype}")
            _equal_arrays([x[n] for n in names], [y[n] for n in names],
                          what)
        elif x.shape != y.shape or not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"{what}: output {k} not equal bit for bit")


def localize_api_phase(movie, locs, ids, camera, params, counted,
                       smi: str) -> dict:
    """20 (a). The rest of the localize API on the slices' movie: the
    legacy identification against identify's rows, localize's perf=,
    frame_chunk and abort_callback of localize_fused, a camera of 0-d
    arrays (path ``camera-array``) and the legacy fit (path ``fit``).
    Returns the launches of those two paths."""
    import torch

    from picasso_torch import localize
    from picasso_torch.ops import fused

    t0 = time.perf_counter()
    for f in API_FRAMES:
        rows = ids[ids["frame"] == f]
        got = localize.identify_by_frame_number(movie, MIN_NG, BOX, f,
                                                device="cuda")
        y, x, ng = localize.identify_in_frame(movie[f], MIN_NG, BOX,
                                              device="cuda")
        if not (np.array_equal(got, rows) and np.array_equal(y, rows["y"])
                and np.array_equal(x, rows["x"])
                and np.array_equal(ng, rows["net_gradient"])):
            raise AssertionError(f"legacy identification of frame {f} "
                                 "differs from identify's rows")
    t_id = time.perf_counter() - t0
    perf = {}
    got, wall, _ = counted(lambda: localize.localize(
        movie, dict(camera), params, fitting_method="gaussmle", perf=perf,
        device="cuda"))
    _equal_arrays([got], [locs], "localize(perf=) vs the MLE slice")
    perf128 = {}
    base = fused.localize_fused(movie, MIN_NG, BOX, camera, device="cuda")
    chunked = fused.localize_fused(movie, MIN_NG, BOX, camera,
                                   frame_chunk=API_FRAME_CHUNK, perf=perf128,
                                   device="cuda")
    _equal_arrays([chunked[0], *chunked[1]], [base[0], *base[1]],
                  f"frame_chunk={API_FRAME_CHUNK} vs the default")
    polls = []

    def abort():
        polls.append(1)
        return len(polls) >= 2

    aborted = fused.localize_fused(movie, MIN_NG, BOX, camera,
                                   frame_chunk=API_FRAME_CHUNK,
                                   abort_callback=abort, device="cuda")
    if aborted[0] is not None or aborted[1] is not None or len(polls) != 2:
        raise AssertionError("abort_callback at the second chunk did not "
                             "stop localize_fused")
    cam0 = {k: np.array(v) for k, v in camera.items()}
    got0, wall0, launches_cam = counted(lambda: localize.localize(
        movie, cam0, params, fitting_method="gaussmle", device="cuda"))
    _equal_arrays([got0], [locs],
                  "the 0-d camera (identify + fit2D) vs the MLE slice")
    ids0 = ids[ids["frame"] < CHUNK]
    legacy, wall_fit, launches_fit = counted(lambda: localize.fit(
        movie, dict(camera), ids0, BOX, device="cuda"))
    ref, _ = localize.fit2D(movie, [{"Frames": len(movie)}], dict(camera),
                            ids0, BOX, fitting_method="gaussmle",
                            device="cuda")
    torch.cuda.synchronize()
    h = BOX // 2
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    dx = np.abs(f64(legacy["x"]) - (f64(ref["y"]) - ids0["y"] + ids0["x"]
                                     + h))
    dy = np.abs(f64(legacy["y"]) - (f64(ref["x"]) - ids0["x"] + ids0["y"]
                                     + h))
    if not (max(dx.max(), dy.max()) <= FIT_OFFSET_ABS
            and np.array_equal(legacy["sx"], ref["sy"])
            and np.array_equal(legacy["sy"], ref["sx"])
            and np.array_equal(legacy["photons"], ref["photons"])
            and np.array_equal(legacy["frame"], ref["frame"])):
        raise AssertionError(f"legacy fit vs fit2D: x/y off the relation by "
                             f"{dx.max():.3e} / {dy.max():.3e} px (bound "
                             f"{FIT_OFFSET_ABS:.3e}) or sx/sy not swapped")
    print(f"localize API ({smi}): identify_by_frame_number and "
          f"identify_in_frame on frames {list(API_FRAMES)} == identify's "
          f"rows ({t_id:.3f} s); localize MLE with perf= {wall:.3f} s == "
          f"the MLE slice bit for bit, perf " + json.dumps(perf))
    print(f"  localize_fused frame_chunk={API_FRAME_CHUNK} == the default "
          "bit for bit, perf " + json.dumps(perf128) + "; abort_callback "
          "at the second chunk -> (None, None)")
    print(f"  camera of 0-d arrays (identify + fit2D, host photons) "
          f"{wall0:.3f} s == the MLE slice bit for bit, launches "
          f"{launches_cam}")
    print(f"  legacy fit of chunk 0's {len(ids0)} ids {wall_fit:.3f} s, "
          f"launches {launches_fit}: x = fit2D's y offset + x + {h}, y = "
          f"fit2D's x offset + y + {h} within {max(dx.max(), dy.max()):.3e} "
          f"px (bound {FIT_OFFSET_ABS:.3e}), sx/sy swapped, photons equal")
    return {"fit": launches_fit, "camera-array": launches_cam}


def simulate_phase(counted, smi: str) -> dict:
    """20 (b). Closed loop: simulate.simulate_movie on the host at each of
    SIM_CONFIGS, then MLE localize on the card against the sites.
    Returns the launches of the simulations (path ``simulate``)."""
    from scipy.spatial import cKDTree

    from picasso_torch import localize, simulate

    cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    runs = []
    for cfg in SIM_CONFIGS:
        (movie, sites, info), wall_sim, launches = counted(
            lambda: simulate.simulate_movie(**cfg))
        runs.append(launches)
        locs, wall_loc, launches_loc = counted(lambda: localize.localize(
            movie, dict(cam), {"Min. Net Gradient": SIM_MIN_NG,
                               "Box Size": BOX},
            movie_info=[info], fitting_method="gaussmle", device="cuda"))
        d, _ = cKDTree(sites).query(np.column_stack([locs["x"], locs["y"]]))
        med = float(np.median(d)) if len(d) else float("inf")
        print(f"closed loop ({smi}): simulate_movie({cfg}) {movie.shape} "
              f"on the host {wall_sim:.3f} s; localize MLE on the card "
              f"{wall_loc:.3f} s, {len(locs)} locs, median distance to the "
              f"nearest site {med:.4f} px, within 1 px "
              f"{np.mean(d < 1):.4f}; launches {launches_loc}")
        if not (len(locs) > SIM_MIN_LOCS and med < SIM_MEDIAN_PX
                and launches_loc["K4"] and launches_loc["K5 mle queue"]):
            raise AssertionError(f"closed loop {cfg}: {len(locs)} locs, "
                                 f"median {med} px")
    return _sum_launches(*runs)


def nanotron_phase(counted, smi: str) -> dict:
    """20 (c). nanotron on two origami designs: prepare_data, train_model
    at its defaults and predict_structure on the card (path
    ``nanotron``), held-out accuracy, then card == CPU from the same
    weights. Returns the path's launches."""
    import torch

    from picasso_torch import nanotron
    from torch_data import (make_origami_locs, origami_groups,
                            origami_rows_template)
    from torch_parity import compare_mlp

    groups = {}
    for label, tmpl, seed in ((0, None, NANO_SEEDS[0]),
                              (1, origami_rows_template(), NANO_SEEDS[1])):
        locs, _, truth = make_origami_locs(N_NANO_PICKS, seed, template=tmpl)
        groups[label] = origami_groups(locs, truth)
    walls = {}

    def main_path():
        data = {}
        t0 = time.perf_counter()
        for label, g in groups.items():
            data[label] = np.stack(nanotron.prepare_data(
                g, label, NANO_RADIUS, NANO_OVERSAMPLING, device="cuda",
                walls=walls)[0])
        walls["prepare"] = time.perf_counter() - t0
        n_tr = 4 * N_NANO_TRAIN
        X_tr = np.concatenate([d[:n_tr] for d in data.values()])
        X_te = np.concatenate([d[n_tr:] for d in data.values()])
        y_tr = np.repeat(list(data), n_tr)
        y_te = np.repeat(list(data), [len(d) - n_tr for d in data.values()])
        t0 = time.perf_counter()
        model = nanotron.train_model(list(X_tr), list(y_tr), device="cuda")
        torch.cuda.synchronize()
        walls["train"] = time.perf_counter() - t0
        acc = model.score(X_te, y_te)
        held = [(label, pick) for label in groups
                for pick in range(N_NANO_TRAIN,
                                  N_NANO_TRAIN + N_PREDICT // 2)]
        t0 = time.perf_counter()
        preds = [nanotron.predict_structure(
            model, groups[label], pick, NANO_RADIUS, NANO_OVERSAMPLING,
            device="cuda")[0][0] for label, pick in held]
        walls["predict"] = time.perf_counter() - t0
        return model, acc, X_tr, y_tr, X_te, preds, held, data

    (model, acc, X_tr, y_tr, X_te, preds, held, data), wall, launches = (
        counted(main_path))
    # predict_structure renders a pick as prepare_data's unturned image
    want = [model.predict(data[label][4 * pick][None])[0]
            for label, pick in held]
    steps = model.max_iter * (len(X_tr) // min(model.batch_size, len(X_tr)))
    print(f"nanotron ({smi}): {N_NANO_PICKS} origami picks a class (11 and "
          f"8 sites), {X_tr.shape[1]}-pixel images; prepare_data "
          f"{walls['prepare']:.3f} s (render {walls['render']:.3f} s, "
          f"rotations {walls['rotations']:.3f} s); train_model "
          f"{walls['train']:.3f} s, {steps} steps = "
          f"{steps / walls['train']:.1f} steps/s, loss "
          f"{model.loss_curve_[0]:.4g} -> {model.loss_curve_[-1]:.4g}; "
          f"held-out accuracy {acc:.4f} on "
          f"{len(X_te)} images; predict_structure "
          f"{1e3 * walls['predict'] / len(held):.2f} ms a pick; "
          f"launches {launches}")
    if acc < NANO_ACCURACY or preds != want:
        raise AssertionError(f"nanotron: held-out accuracy {acc} (gate "
                             f"{NANO_ACCURACY}) or predict_structure differs")
    init = nanotron.init_params([X_tr.shape[1], 100, 2], seed=0)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m = nanotron.MLPClassifier(max_iter=NANO_CARD_CPU_EPOCHS,
                                   device=dev).fit(X_tr, y_tr, params=init)
        runs[dev] = m, time.perf_counter() - t0
    (mc, tc), (mp, tp) = runs["cuda"], runs["cpu"]
    stats = compare_mlp(mc.loss_curve_, mp.loss_curve_, mc.predict(X_te),
                        mp.predict(X_te), what="nanotron card vs CPU")
    print(f"  card == CPU from the same weights, {NANO_CARD_CPU_EPOCHS} "
          f"epochs: card {tc:.3f} s, CPU {tp:.3f} s; " + json.dumps(stats))
    return launches


def average3_phase(counted, smi: str) -> dict:
    """20 (d). average3 on the card: JAX's recipe with JAX's gates and 3D
    origami at the defaults (path ``average3``), each pass's wall split,
    card == CPU pass by pass. Returns the path's launches."""
    from picasso_torch import average3, lib
    from torch_data import (make_average3_locs, make_origami3d_locs,
                            rigid_rotations, rotation_share, xy_spread)
    from torch_parity import compare_average3_passes

    def z_std(locs):
        _, rows = lib.group_rows(locs["group"])
        return float(np.std([np.mean(locs["z"][r], dtype=np.float64)
                             for r in rows], ddof=1))

    def split(walls):
        return json.dumps([{k: (round(v, 4) if isinstance(v, float) else v)
                            for k, v in w.items()} for w in walls])

    info_l = [{"Frames": 100, "Height": 64, "Width": 64, "Pixelsize": 130}]
    recipe = make_average3_locs(N_AVG3_GROUPS)
    kw = dict(iterations=2, oversampling=8, rot_axes=("z",))
    walls, picks = [], []
    out, wall, launches_l = counted(lambda: average3.average3(
        recipe, info_l, device="cuda", walls=walls, picks=picks, **kw))
    spread = (xy_spread(recipe), xy_spread(out))
    picks_cpu = []
    t0 = time.perf_counter()
    average3.average3(recipe, info_l, device="cpu", picks=picks_cpu, **kw)
    t_cpu = time.perf_counter() - t0
    held = compare_average3_passes(picks, picks_cpu,
                                   "average3 recipe card vs CPU")
    print(f"average3 ({smi}): JAX's recipe, {N_AVG3_GROUPS} groups "
          f"({len(recipe)} locs), 2 iterations about z at oversampling 8: "
          f"card {wall:.3f} s, CPU {t_cpu:.3f} s; spread {spread[0]:.4f} -> "
          f"{spread[1]:.4f}, z means' std {z_std(recipe):.3f} -> "
          f"{z_std(out):.3g} nm; card == CPU: {held}; passes {split(walls)}")
    if not (spread[1] < spread[0] - AVG3_SPREAD_FALL
            and z_std(out) < AVG3_Z_STD):
        raise AssertionError(f"average3 recipe: spread {spread}, z std "
                             f"{z_std(out)}")
    origami, info_o, truth = make_origami3d_locs(N_ORIGAMI3D, ORIGAMI_SEED)
    walls, picks = [], []
    out, wall, launches_o = counted(lambda: average3.average3(
        origami, info_o, device="cuda", walls=walls, picks=picks))
    centred = average3._com_align3(origami)
    ids, rows = lib.group_rows(origami["group"])
    share = rotation_share(rigid_rotations(centred, out, rows),
                           truth["angles"][ids],
                           2 * average3._workspace(centred, 130, 10.0,
                                                   None)[2][1])
    print(f"  {N_ORIGAMI3D} 3D origami ({len(origami)} locs) at the "
          f"defaults (3 iterations, oversampling 10, axes z, x, y): card "
          f"{wall:.3f} s; z means' std {z_std(origami):.3f} -> "
          f"{z_std(out):.3f} nm; spread (centred) {xy_spread(centred):.4f} "
          f"-> {xy_spread(out):.4f}; in-plane rotations within 2 angle steps"
          f" of the truth {share[0]:.4f}, or of its turn by pi {share[1]:.4f}"
          f"; passes {split(walls)}")
    if z_std(out) >= AVG3_Z_STD:
        raise AssertionError(f"average3 origami: z std {z_std(out)}")
    sub = origami[np.isin(origami["group"], ids[:N_AVG3_CARD_CPU])]
    runs = {}
    for dev in ("cuda", "cpu"):
        p = []
        t0 = time.perf_counter()
        average3.average3(sub, info_o, device=dev, picks=p)
        runs[dev] = p, time.perf_counter() - t0
    held = compare_average3_passes(runs["cuda"][0], runs["cpu"][0],
                                   "average3 origami card vs CPU")
    print(f"  card == CPU on {N_AVG3_CARD_CPU} origami: card "
          f"{runs['cuda'][1]:.3f} s, CPU {runs['cpu'][1]:.3f} s; {held}")
    return _sum_launches(launches_l, launches_o)


def picks_phase(counted, smi: str) -> tuple[dict, dict]:
    """21. The pick analyses and the Mask tool on phase 18's origami
    field: (a) pick_similar from N_SEED_PICKS seed circles on the card and
    the CPU, held by torch_parity.compare_similar_picks and to the truth,
    then on the card alone on a camera-sized field; (b) pick_properties,
    evaluate_picks and pick_kinetics of (a)'s picks, card == CPU; (c)
    remove_locs_in_picks (host) and combine_locs_in_picks, card == CPU;
    (d) generate_image card == CPU bit for bit, mask_image by every method
    and mask_locs. Returns the launches of the paths ``picks`` ((a)-(c)
    on the card) and ``mask`` ((d))."""
    from scipy.spatial import cKDTree

    from picasso_torch import lib, masking, postprocess
    from torch_data import make_origami_locs
    from torch_parity import compare_similar_picks, compare_tables_ulps

    pool = ThreadPoolExecutor(1)
    camera_job = pool.submit(make_origami_locs, CAMERA_ORIGAMI, CAMERA_SEED)
    locs, info, truth = make_origami_locs(N_ORIGAMI, ORIGAMI_SEED)

    def similar(field, field_info, field_truth, dev):
        """pick_similar from circles on the field's first N_SEED_PICKS
        true centres."""
        rec = {}
        seeds = [tuple(map(float, c))
                 for c in field_truth["centers"][:N_SEED_PICKS]]
        out = postprocess.pick_similar(field, field_info, seeds, PICK_D,
                                       device=dev, record=rec)
        return out, rec

    def farthest(picks, centers):
        return float(cKDTree(centers).query(np.array(picks, np.float64))[
            0].max()) if picks else float("inf")

    def walls(rec):
        return json.dumps({k: round(v, 4) for k, v in rec["walls"].items()})

    # (a) pick similar
    (picks, rec), wall_sim, launches_sim = counted(
        lambda: similar(locs, info, truth, "cuda"))
    t0 = time.perf_counter()
    picks_cpu, rec_cpu = similar(locs, info, truth, "cpu")
    wall_sim_cpu = time.perf_counter() - t0
    held = compare_similar_picks(picks, rec, picks_cpu, rec_cpu,
                                 "pick_similar card vs CPU")
    far = (farthest(picks, truth["centers"]),
           farthest(picks_cpu, truth["centers"]))
    print(f"picks ({smi}): pick_similar on {N_ORIGAMI} origami "
          f"({len(locs)} locs) from {N_SEED_PICKS} circles of {PICK_D} px: "
          f"{len(picks)} picks (CPU {len(picks_cpu)}), card {wall_sim:.3f} s"
          f" {walls(rec)} ({int(rec['started'].sum())} of "
          f"{len(rec['started'])} candidates walked, at most "
          f"{int(rec['steps'].max())} steps), CPU {wall_sim_cpu:.3f} s "
          f"{walls(rec_cpu)}; card vs CPU: {held['matched']} matched, at "
          f"most {held['worst_px']:.3e} px apart (bound "
          f"{held['same_px']:.3e}), near ties paired {held['stepped']}, "
          f"alone {held['got_alone']} / {held['ref_alone']}; farthest "
          f"from a true centre {far[0]:.4f} / {far[1]:.4f} px")
    c_locs, c_info, c_truth = camera_job.result()
    pool.shutdown()
    (c_picks, c_rec), wall_cam, launches_cam = counted(
        lambda: similar(c_locs, c_info, c_truth, "cuda"))
    c_far = farthest(c_picks, c_truth["centers"])
    print(f"  camera-sized field: {CAMERA_ORIGAMI} origami ({len(c_locs)} "
          f"locs, {c_info[0]['Width']} x {c_info[0]['Height']} px): "
          f"{len(c_picks)} picks, card {wall_cam:.3f} s {walls(c_rec)} "
          f"({int(c_rec['started'].sum())} of {len(c_rec['started'])} "
          f"candidates walked); farthest from a true centre {c_far:.4f} px")
    if max(far + (c_far,)) > SIMILAR_TRUTH_PX or not (picks and c_picks):
        raise AssertionError(f"pick_similar: picks {far}, {c_far} px from "
                             f"a true centre (bound {SIMILAR_TRUTH_PX})")
    # (b) pick properties
    picked = postprocess.picked_locs(locs, info, picks, "Circle",
                                     PROPS_RADIUS)
    areas = lib.pick_areas("Circle", picks, 2 * PROPS_RADIUS)
    kw = dict(max_dark_time=PROPS_DARK)
    props, wall_props, launches_props = counted(
        lambda: postprocess.pick_properties(
            picked, info, influx_rate=PROPS_INFLUX, pick_areas=areas,
            device="cuda", **kw))
    t0 = time.perf_counter()
    props_cpu = postprocess.pick_properties(
        picked, info, influx_rate=PROPS_INFLUX, pick_areas=areas,
        device="cpu", **kw)
    wall_props_cpu = time.perf_counter() - t0
    fits = ("pick_area_um2", "n_units", "locs", "length_cdf", "dark_cdf",
            "qpaint_idx_cdf")
    stats = [n for n in props.dtype.names if n not in fits]
    ulp_props = compare_tables_ulps(props[stats], props_cpu[stats], 1,
                                    "pick_properties card vs CPU")
    for n in fits:
        if not np.array_equal(props[n], props_cpu[n]):
            raise AssertionError(f"pick_properties: {n} card != CPU")
    evals, wall_eval, launches_eval = counted(
        lambda: postprocess.evaluate_picks(picked, info, device="cuda",
                                           **kw))
    evals_cpu = postprocess.evaluate_picks(picked, info, device="cpu", **kw)
    kin, wall_kin, launches_kin = counted(
        lambda: postprocess.pick_kinetics(picked, info, device="cuda", **kw))
    kin_cpu = postprocess.pick_kinetics(picked, info, device="cpu", **kw)
    for a, b in list(zip(evals[:6], evals_cpu[:6])) + list(zip(kin[:3],
                                                               kin_cpu[:3])):
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError("evaluate_picks / pick_kinetics: card != "
                                 "CPU")
    ulp_ev = (compare_tables_ulps(evals[6], evals_cpu[6], 1, "events"),
              compare_tables_ulps(kin[3], kin_cpu[3], 1, "events"))
    # the split of pick_properties: one link + dark_times on the card, the
    # fits a pick at a time on the host, groupprops on the card
    split = {}
    t0 = time.perf_counter()
    events, pick = postprocess._pick_events(picked, info, PROPS_DARK, "cuda")
    split["link + dark_times"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _, rows in postprocess._pick_spans(pick):
        lib.estimate_kinetic_rate(events["len"][rows])
        lib.estimate_kinetic_rate(events["dark"][rows])
    split["host fits"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    postprocess.groupprops(kin[3], device="cuda")
    split["groupprops"] = time.perf_counter() - t0
    print(f"  pick_properties of {len(picked)} picks ({sum(map(len, picked))}"
          f" locs in circles of {PROPS_RADIUS} px, max_dark_time "
          f"{PROPS_DARK}, influx {PROPS_INFLUX}): {len(props)} rows, card "
          f"{wall_props:.3f} s (" + ", ".join(
              f"{k} {v:.3f} s" for k, v in split.items())
          + f"), CPU {wall_props_cpu:.3f} s; median n_units "
          f"{float(np.median(props['n_units'])):.3f}; evaluate_picks card "
          f"{wall_eval:.3f} s, pick_kinetics card {wall_kin:.3f} s; card =="
          f" CPU: fits and counts equal, group statistics within one f32 "
          f"ulp ({ulp_props} cells differ), events ({ulp_ev[0]}, "
          f"{ulp_ev[1]} cells differ)")
    # (c) remove and combine
    t0 = time.perf_counter()
    left = postprocess.remove_locs_in_picks(
        locs, info, picks=picks, pick_shape="Circle", pick_size=PICK_D)
    wall_rm = time.perf_counter() - t0
    rows = postprocess._picked_rows(locs, info, picks, "Circle", PICK_D / 2)
    keep = np.ones(len(locs), bool)
    keep[rows] = False
    if not (len(left) + len(rows) == len(locs)
            and np.array_equal(left, locs[keep])):
        raise AssertionError("remove_locs_in_picks: the rows left and the "
                             "picked rows are not the input")
    ckw = dict(picks=picks, pick_shape="Circle", pick_size=PICK_D)
    combined, wall_comb, launches_comb = counted(
        lambda: postprocess.combine_locs_in_picks(locs, info, device="cuda",
                                                  **ckw))
    t0 = time.perf_counter()
    combined_cpu = postprocess.combine_locs_in_picks(locs, info,
                                                     device="cpu", **ckw)
    wall_comb_cpu = time.perf_counter() - t0
    ulp_comb = compare_tables_ulps(combined, combined_cpu, 1,
                                   "combine_locs_in_picks card vs CPU")
    print(f"  remove_locs_in_picks (host) {wall_rm:.3f} s: {len(left)} left "
          f"+ {len(rows)} picked = {len(locs)}; combine_locs_in_picks: "
          f"{len(combined)} events of {len(picks)} picks, card "
          f"{wall_comb:.3f} s, CPU {wall_comb_cpu:.3f} s; card == CPU "
          f"within one f32 ulp ({ulp_comb} cells differ)")
    # (d) the Mask tool
    image, wall_img, launches_mask = counted(lambda: masking.generate_image(
        locs, info, MASK_PX, MASK_BLUR, device="cuda"))
    t0 = time.perf_counter()
    image_cpu = masking.generate_image(locs, info, MASK_PX, MASK_BLUR,
                                       device="cpu")
    wall_img_cpu = time.perf_counter() - t0
    if not np.array_equal(image, image_cpu):
        raise AssertionError("generate_image: card != CPU")
    t0 = time.perf_counter()
    masks = {m: masking.mask_image(image, m)
             for m in masking.THRESHOLD_METHODS}
    wall_masks = time.perf_counter() - t0
    for m, mask in masks.items():
        if not np.array_equal(mask, masking.mask_image(image_cpu, m)):
            raise AssertionError(f"mask_image {m}: card's image != CPU's")
    inside, outside = masking.mask_locs(locs, masks["otsu"], info=info)
    if len(inside) + len(outside) != len(locs):
        raise AssertionError("mask_locs: inside + outside != all")
    print(f"  mask: generate_image at {MASK_PX} nm, blur {MASK_BLUR} nm, "
          f"{image.shape}: card {wall_img:.3f} s, CPU {wall_img_cpu:.3f} s, "
          f"equal bit for bit; mask_image by the {len(masks)} methods "
          f"{wall_masks:.3f} s (mask shares " + json.dumps(
              {m: round(float(v.mean()), 4) for m, v in masks.items()})
          + f"), each the CPU image's; mask_locs (otsu): {len(inside)} in + "
          f"{len(outside)} out")
    return (_sum_launches(launches_sim, launches_cam, launches_props,
                          launches_eval, launches_kin, launches_comb),
            launches_mask)


def _timed(fn):
    """(fn(), wall seconds) between two synchronizes of the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _moved(locs, window, ang, oversampling, dev) -> int:
    """The locs of a rotated view whose display pixel (f32, as the device
    route truncates it) or in-view test differs card vs CPU: a loc on a
    bin edge after the rotation's last-ulp roundings."""
    from picasso_torch import render

    (y0, x0), (y1, x1) = window
    out = []
    for d in (dev, "cpu"):
        x, y, in_view, _ = render._rotate(
            render.columns(locs, ("x", "y", "z"), d), oversampling, x0, x1,
            y0, y1, ang)
        full = np.full((len(locs), 2), -1, np.int64)
        full[in_view.cpu().numpy()] = np.stack(
            [x.float().long().cpu().numpy(), y.float().long().cpu().numpy()],
            1)
        out.append(full)
    return int((out[0] != out[1]).any(1).sum())


def render3d_phase(locs3d, locs3d_lq, info3d, locs2d, info2d, counted,
                   smi: str, dev="cuda") -> dict:
    """22. The rest of render and io on phase 11's localize_3D locs (z and
    lpz in camera px for the rotated views): (a) every blur of the whole
    field at RENDER_OVERSAMPLING tilted by TILT and by (0, 0, 0) on the
    card (walls, peak memory, the mass in view), the covariance splat's
    wall split into rotation, covariances and bucket splats with the
    bucket counts; on WINDOW_3D the card against the CPU, histograms,
    smooth and convolve equal but for the locs on a bin edge (counted),
    the splats within rtol 1e-5 + atol 1e-6; (b) render_hist3d and
    render_hist3d_anisotropic of the whole field over the locs' z range
    on the card, the total the in-view count, card == CPU on the window;
    (c) render_scene of two channels (MLE, LQ) with LUT colours and one
    with a LUT colormap, the whole field on the card, the window card vs
    CPU within one level; (d) build_render_index on the undrifted MLE
    slice's locs and query_viewport of INDEX_VIEWS against a brute-force
    test of the index's blocks; (e) the text exporters of the 3D locs
    into a temporary folder and import_ts of the ThunderSTORM file back.
    Returns the launches of the path ``render3d`` ((a)-(c))."""
    import torch

    from picasso_torch import io, render, spatial_index
    from picasso_torch.ops import render_ops

    px = info3d[0]["Pixelsize"]
    locs = locs3d.copy()
    for c in ("z", "lpz"):
        locs[c] = locs3d[c] / px
    runs = []
    os_ = RENDER_OVERSAMPLING
    field = ((0, 0), (info3d[0]["Height"], info3d[0]["Width"]))

    # (a) rotated views
    for ang in (TILT, (0.0, 0.0, 0.0)):
        line = []
        for blur in render.BLUR_METHODS:
            torch.cuda.reset_peak_memory_stats()
            (n, img), wall, launches = counted(lambda: render.render(
                locs, info3d, os_, blur_method=blur, ang=ang,
                min_blur_width=RENDER3D_MIN_BLUR, device=dev))
            runs.append(launches)
            peak = torch.cuda.max_memory_allocated() / 2**30
            # the counts are the locs in view (less any truncated onto the
            # far edge); a blur keeps most of their mass, a splat's sum
            # over pixel centres is near 1 a loc on average
            mass = float(img.astype(np.float64).sum())
            lo, hi = ((n - 2, n) if blur is None else (0.95 * n, n * (
                1 + 1e-5)) if blur in ("smooth", "convolve") else
                (0.95 * n, 1.05 * n))
            if not (np.isfinite(img).all() and lo <= mass <= hi):
                raise AssertionError(f"rotated render {blur} {ang}: mass "
                                     f"{mass} of {n} locs in view")
            line.append(f"{blur} {wall:.3f} s ({peak:.2f} GiB, mass "
                        f"{mass / n:.4f})")
        lp = np.percentile(locs["lpx"], [0, 1, 50, 99])
        print(f"render3d ({smi}): {len(locs)} 3D locs, z and lpz in px "
              f"(lpx percentiles 0/1/50/99 {np.round(lp, 5).tolist()} px, "
              f"median lpz {float(np.median(locs['lpz'])):.5f} px), min. "
              f"blur {RENDER3D_MIN_BLUR} px, the field at oversampling {os_} "
              f"{img.shape} turned by {ang}, {n} in view: card "
              + "; ".join(line))
    cols = render.columns(locs, ("x", "y", "z", "lpx", "lpy", "lpz"), dev)
    R = render.to_rotation(TILT).as_matrix()
    (x, y, in_view, _), t_rot = _timed(lambda: render._rotate(
        cols, os_, 0, field[1][1], 0, field[1][0], TILT))
    sx, sy, sz = (os_ * torch.clamp(cols[c], min=RENDER3D_MIN_BLUR)[in_view]
                  for c in ("lpx", "lpy", "lpz"))
    for blur in ("gaussian", "gaussian_iso"):
        if blur == "gaussian_iso":
            sx = sy = (sx + sy) / 2
        covs, t_cov = _timed(lambda: render._rotated_covariances(sx, sy, sz,
                                                                 R))
        _, t_splat = _timed(lambda: render_ops.gaussian_splat_cov(
            x, y, covs, *img.shape))
        need = (2 * 3.0 * torch.sqrt(torch.maximum(covs[:, 0, 0], covs[
            :, 1, 1])) + 2).cpu().numpy()
        edges = [0, 8, 16, 32, 64, np.inf]
        buckets = {f"W{w}": int(((need > a) & (need <= b)).sum()) for w, a, b
                   in zip((8, 16, 32, 64, 128), edges[:-1], edges[1:])}
        print(f"  {blur} split: rotation {t_rot:.4f} s, covariances "
              f"{t_cov:.4f} s, bucket splats {t_splat:.4f} s; locs by "
              f"bucket {json.dumps(buckets)}")
    (wy0, wx0), (wy1, wx1) = WINDOW_3D
    moved = _moved(locs, WINDOW_3D, TILT, os_, dev)
    line = []
    for blur in render.BLUR_METHODS:
        kw = dict(viewport=WINDOW_3D, blur_method=blur, ang=TILT,
                  min_blur_width=RENDER3D_MIN_BLUR)
        (n_g, g), wall, launches = counted(lambda: render.render(
            locs, info3d, os_, device=dev, **kw))
        runs.append(launches)
        t0 = time.perf_counter()
        n_c, c = render.render(locs, info3d, os_, device="cpu", **kw)
        wall_c = time.perf_counter() - t0
        if min(n_g, n_c) < render_ops.DEVICE_MIN_LOCS or abs(n_g - n_c) > \
                moved:
            raise AssertionError(f"render3d window {blur}: {n_g} / {n_c} in "
                                 "view")
        d = np.abs(g.astype(np.float64) - c)
        if blur in (None, "smooth", "convolve"):
            ok = (d.max() == 0 if moved == 0
                  else d.sum() <= 2 * moved * (1 + 1e-6))
            held = f"equal {d.max() == 0}"
        else:
            ok = bool((d <= 1e-6 + 1e-5 * np.abs(c)).all())
            held = f"max|d|/max {d.max() / c.max():.3g}"
        if not ok:
            raise AssertionError(f"render3d window {blur}: card vs CPU")
        line.append(f"{blur} card {wall:.3f} s, CPU {wall_c:.3f} s, {held}")
    print(f"  window {WINDOW_3D} ({n_g} locs in view), card vs CPU, {moved} "
          "locs on a bin edge: " + "; ".join(line))

    # (b) 3D histograms
    x, y, z = locs3d["x"], locs3d["y"], locs3d["z"]
    inside = (x > 0) & (y > 0) & (x < field[1][1]) & (y < field[1][0])
    z_lo, z_hi = float(z[inside].min()) - 1.0, float(z[inside].max()) + 1.0
    for name, extra in (("render_hist3d", ()),
                        ("render_hist3d_anisotropic",
                         (HIST3D_Z_OVERSAMPLING,))):
        fn = getattr(render, name)
        torch.cuda.reset_peak_memory_stats()
        (n, vol), wall, launches = counted(lambda: fn(
            x, y, z, os_, *extra, 0, 0, field[1][0], field[1][1], z_lo, z_hi,
            px, device=dev))
        runs.append(launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        total = int(vol.sum(dtype=np.float64))
        shape = vol.shape
        del vol
        win = (os_, *extra, wy0, wx0, wy1, wx1, z_lo, z_hi, px)
        (n_g, g), wall_w, launches = counted(lambda: fn(x, y, z, *win,
                                                        device=dev))
        runs.append(launches)
        n_c, c = fn(x, y, z, *win, device="cpu")
        if total != n or n_g != n_c or not np.array_equal(g, c):
            raise AssertionError(f"{name}: total {total} of {n} in view, or "
                                 "the window's card != CPU")
        print(f"  {name}: {shape} ({np.prod(shape) * 4 / 2**30:.2f} GiB f32)"
              f" of {n} locs, z {z_lo:.1f}..{z_hi:.1f} nm: card {wall:.3f} s"
              f" (readback included), peak {peak:.2f} GiB, total == in view; "
              f"window {g.shape} card {wall_w:.3f} s == CPU ({n_g} locs)")

    # (c) the scene
    # LUTs that rise by less than a level an index: a value on an index's
    # edge card vs CPU then moves its colour by one level at most
    luts = [render.solid_to_lut((1.0, 0.35, 0.0)), render.stops_to_lut(
        [(0.0, 0.0, 0.0, 0.0), (0.5, 0.2, 0.4, 0.45), (1.0, 0.65, 0.85, 0.9)])]
    for what, scene_locs, scene_info, kw in (
            ("MLE + LQ, LUT colours", [locs3d, locs3d_lq], [info3d, info3d],
             dict(colors=luts)),
            ("MLE, LUT colormap", locs3d, info3d,
             dict(single_channel_colormap=luts[1]))):
        kw.update(disp_px_size=SCENE_PX, blur_method="gaussian")
        (rgb, n), wall, launches = counted(lambda: render.render_scene(
            scene_locs, scene_info, device=dev, **kw))
        runs.append(launches)
        (rgb_g, n_g), wall_w, launches = counted(lambda: render.render_scene(
            scene_locs, scene_info, viewport=WINDOW_3D, device=dev, **kw))
        runs.append(launches)
        rgb_c, n_c = render.render_scene(scene_locs, scene_info,
                                         viewport=WINDOW_3D, device="cpu",
                                         **kw)
        d = np.abs(rgb_g.astype(int) - rgb_c)
        side = int(np.ceil(px / SCENE_PX * field[1][0]))
        if n_g != n_c or d.max() > 1 or rgb.shape != (side, side, 3):
            raise AssertionError(
                f"render_scene {what}: card vs CPU ({n_g} / {n_c} locs, "
                f"{int(d.any(2).sum())} pixels differ by up to {d.max()}; "
                f"shape {rgb.shape})")
        print(f"  render_scene {what}: {rgb.shape} of {n} locs, card "
              f"{wall:.3f} s; window {rgb_g.shape} card {wall_w:.3f} s vs "
              f"CPU: {int(d.any(2).sum())} pixels differ, by at most "
              f"{int(d.max())} level")

    # (d) the render index
    pyramid, wall = _timed(lambda: spatial_index.build_render_index(locs2d,
                                                                    info2d))
    line = []
    for vp in INDEX_VIEWS:
        got, wall_q = _timed(lambda: spatial_index.query_viewport(pyramid,
                                                                  vp))
        (y0, x0), (y1, x1) = vp
        if got is None:
            area = (y1 - y0) * (x1 - x0) / (pyramid.width * pyramid.height)
            if area < 0.1:
                raise AssertionError(f"query_viewport {vp}: bypassed")
            line.append(f"{vp} bypassed {wall_q * 1e3:.3f} ms")
            continue
        lvl = spatial_index._select_level(pyramid, vp)
        size = pyramid.block_sizes[lvl]
        K, L = pyramid.block_starts[lvl].shape
        bx = np.clip(np.floor(locs2d["x"] / size), 0, L - 1)
        by = np.clip(np.floor(locs2d["y"] / size), 0, K - 1)
        blocks = np.nonzero(
            (bx >= max(0, np.floor(x0 / size)))
            & (bx <= min(L - 1, np.floor(x1 / size)))
            & (by >= max(0, np.floor(y0 / size)))
            & (by <= min(K - 1, np.floor(y1 / size))))[0]
        in_vp = np.nonzero((locs2d["x"] >= x0) & (locs2d["x"] < x1)
                           & (locs2d["y"] >= y0) & (locs2d["y"] < y1))[0]
        got = np.sort(got.astype(np.int64))
        if not (np.array_equal(got, blocks) and np.isin(in_vp, got).all()):
            raise AssertionError(f"query_viewport {vp}: not the locs of its "
                                 "blocks")
        line.append(f"{vp} {len(got)} locs ({len(in_vp)} inside) "
                    f"{wall_q * 1e3:.3f} ms")
    print(f"  render index of {len(locs2d)} locs: build {wall:.3f} s; "
          "queries == the brute-force blocks: " + "; ".join(line))

    # (e) the exporters
    with tempfile.TemporaryDirectory(prefix=".smoke-export-",
                                     dir=ROOT) as folder:
        line = []
        for name, ext in (("export_ts", "_ts.csv"),
                          ("export_txt_imagej", "_ij.txt"),
                          ("export_txt_nis", "_nis.txt"),
                          ("export_xyz_chimera", ".xyz"),
                          ("export_3d_visp", ".3d")):
            path = os.path.join(folder, "locs" + ext)
            t0 = time.perf_counter()
            getattr(io, name)(path, locs3d, info3d)
            line.append(f"{name} {time.perf_counter() - t0:.3f} s "
                        f"{os.path.getsize(path) / 2**20:.1f} MiB")
        t0 = time.perf_counter()
        back, back_info = io.import_ts(os.path.join(folder, "locs_ts.csv"),
                                       pixelsize=px)
        wall = time.perf_counter() - t0
    ok = len(back) == len(locs3d) and np.array_equal(back["frame"],
                                                      locs3d["frame"])
    for c in ("x", "y"):
        ulps = np.abs(back[c].view(np.int32).astype(np.int64)
                      - locs3d[c].view(np.int32))
        ok &= bool(ulps.max() <= 2)
    if not ok:
        raise AssertionError("import_ts: the export does not come back")
    print(f"  exports of {len(locs3d)} 3D locs: " + "; ".join(line)
          + f"; import_ts {wall:.3f} s, frames equal, x and y within 2 f32 "
          "ulps")
    return _sum_launches(*runs)


def _rows_equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row i of a equals row i of b bit for bit (NaN equals NaN)."""
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    eq = a == b
    if np.issubdtype(a.dtype, np.floating):
        eq |= np.isnan(a) & np.isnan(b)
    return eq.all(1)


def _equal_fits(a, b) -> bool:
    return all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))


def mesh_phase(movie, camera, segs, origami, counted, smi: str) -> dict:
    """23. Several devices in one process (picasso_torch/parallel): (a) a
    mesh of every visible card, or MESH_SHARDS logical shards of the one
    card; (b) the main path, localize_fused (MLE sigmaxy, box 7, the CLI's
    settings) on the smoke movie over the mesh and on one card in turns,
    hits and fits bit for bit, K4/K5 launches a shard; (c) the sharded
    MLE (both methods) and LM fits of make_spots against the unsharded
    routes bit for bit; (d) identify, the summed histogram, RCC's pair
    correlations of phase 7, SPINNA's candidates of phase 19 (bit for
    bit) and G5M on phase 18's origami (a bucket against the unsharded
    fit, reported; g5m by compare_g5m); (e) the dry run; with two or more cards, each shard's
    outputs on its own card. Returns the launches by path."""
    import torch

    from picasso_torch import g5m, gaussmle, imageprocess, spinna
    from picasso_torch.ops import fused, gmm, identify, identify_cuda, lq
    from picasso_torch.parallel import mesh as pmesh
    from picasso_torch.parallel.dryrun import dryrun_multichip
    from torch_data import SPINNA_CELL, make_spots, spinna_cell
    from torch_parity import compare_fits, compare_g5m

    # (a) the mesh
    n_cards = torch.cuda.device_count()
    mesh = (pmesh.default_mesh() if n_cards > 1
            else pmesh.Mesh(["cuda:0"] * MESH_SHARDS))
    distinct = len(set(mesh.devices))
    print(f"mesh ({smi}): {mesh!r}: {distinct} distinct card(s), "
          f"{mesh.size} shards"
          + ("; logical shards of one card, so its walls measure the "
             "sharding's overhead, not a speed-up across cards"
             if distinct == 1 else ""))
    paths = {}
    one = "cuda:0"

    # (b) the main path, over the mesh and on one card, in turns
    def localize_on(dev):
        return fused.localize_fused(
            movie, MIN_NG, BOX, camera, fitting_method="gaussmle",
            mle_method="sigmaxy", eps=EPS, max_it=MAX_IT, device=dev)

    walls = {"one card": [], "mesh": []}
    for turn in range(MESH_TURNS):
        (ids1, fit1), w1, l1 = counted(lambda: localize_on(one))
        mesh.reset_launches()
        (idsm, fitm), wm, lm = counted(lambda: localize_on(mesh))
        walls["one card"].append(round(w1, 4))
        walls["mesh"].append(round(wm, 4))
        if turn == 0:
            paths["mesh"], shard_launches = lm, [
                {k.rsplit(".", 1)[1]: v for k, v in d.items()}
                for d in mesh.launches]
            ref_ids, ref_fit, ids_m, fit_m = ids1, fit1, idsm, fitm
    for name in ref_ids.dtype.names:
        if not np.array_equal(ids_m[name], ref_ids[name]):
            raise AssertionError(f"mesh localize: hits differ ({name})")
    fits_equal = _equal_fits(fit_m, ref_fit)
    if not fits_equal:
        # the work queues would depend on how a batch is composed
        stats = compare_fits([a.T for a in ref_fit[:2]] + list(ref_fit[2:]),
                             [a.T for a in fit_m[:2]] + list(fit_m[2:]),
                             MAX_IT, "mesh localize vs one card")
        print("  mesh localize fits NOT bit for bit; compare_fits:",
              json.dumps(stats))
    n_chunks = -(-len(movie) // CHUNK)
    for i, d in enumerate(shard_launches):
        if (d.get("identify_tiles") != n_chunks
                or d.get("fit_mle_queue_t") != 2 * n_chunks):
            raise AssertionError(f"mesh shard {i} launches {d}")
    print(f"  localize_fused MLE sigmaxy, {len(movie)} frames, "
          f"{len(ref_ids)} hits: hits equal, theta/crlb/ll/iters "
          f"{'bit for bit' if fits_equal else 'within compare_fits'}; walls "
          f"(s, in turns) one card {walls['one card']}, mesh "
          f"{walls['mesh']}; launches a shard "
          f"{json.dumps(shard_launches)}, in all {json.dumps(paths['mesh'])}")

    # (c) the spot-sharded fits on make_spots
    spots = make_spots(N_SPOTS, BOX, seed=0)
    fit_walls = {}
    for method in ("sigmaxy", "sigma"):
        got, w, launches = counted(lambda: pmesh.fit_mle_sharded(
            spots, EPS, MAX_IT, method, mesh))
        ref, w1, _ = counted(lambda: gaussmle.gaussmle(
            spots, EPS, MAX_IT, method, device=one))
        if not _equal_fits(got, ref):
            raise AssertionError(f"fit_mle_sharded {method} != gaussmle")
        paths["mesh-fits" + ("-sigma" if method == "sigma" else "")] = (
            launches)
        fit_walls[method] = (round(w, 4), round(w1, 4))
    got, w, launches = counted(lambda: pmesh.fit_lq_sharded(
        spots, 30, FTOL, mesh))
    ref, w1, _ = counted(lambda: lq.fit_spots_batched(spots, 30,
                                                      device=one))
    if not np.array_equal(got, ref, equal_nan=True):
        raise AssertionError("fit_lq_sharded != fit_spots_batched")
    for k, v in launches.items():
        paths["mesh-fits"][k] += v
    fit_walls["lq"] = (round(w, 4), round(w1, 4))
    print(f"  fit_mle_sharded (sigmaxy, sigma) and fit_lq_sharded (max_it "
          f"30) on {N_SPOTS} make_spots == gaussmle / fit_spots_batched "
          f"on one card bit for bit; walls (mesh, one card) s "
          f"{json.dumps(fit_walls)}; launches "
          f"{json.dumps(paths['mesh-fits'])}, sigma "
          f"{json.dumps(paths['mesh-fits-sigma'])}")

    # (d) the other sharded stages
    stage = {}

    def run_stages():
        out = {}
        out["identify"] = pmesh.identify_sharded(movie, MIN_NG, BOX,
                                                 mesh=mesh)
        x = (fit_m[0][:, 0] + ids_m["x"] - BOX // 2).astype(np.float32)
        y = (fit_m[0][:, 1] + ids_m["y"] - BOX // 2).astype(np.float32)
        out["xy"] = x, y
        out["hist"] = pmesh.render_hist_sharded(x, y, movie.shape[1:],
                                                mesh=mesh)
        ii, jj = np.triu_indices(len(segs), k=1)
        out["pairs"] = ii, jj
        out["xcorr"] = pmesh.pair_xcorrs_sharded(segs, ii, jj, mesh=mesh)
        return out

    out, w_st, paths["mesh-stages"] = counted(run_stages)
    ids_ref = identify.identify_frames(movie, MIN_NG, BOX, device=one)
    for a, b in zip(out["identify"], ids_ref):
        if not np.array_equal(a, b):
            raise AssertionError("identify_sharded != identify_frames")
    x, y = out["xy"]
    H, W = movie.shape[1:]
    in_view = int(np.sum((x >= 0) & (x < W) & (y >= 0) & (y < H)))
    one_shard = pmesh.render_hist_sharded(x, y, (H, W),
                                          mesh=pmesh.Mesh([one]))
    if out["hist"].sum() != in_view or not np.array_equal(out["hist"],
                                                          one_shard):
        raise AssertionError(f"render_hist_sharded: {out['hist'].sum()} "
                             f"counts of {in_view} locs in view")
    crops = imageprocess.pair_xcorrs(segs, None)[0]
    xc_diff = float(np.abs(out["xcorr"] - crops).max())
    if xc_diff > 1e-9 * float(np.abs(crops).max()):
        raise AssertionError(f"pair_xcorrs_sharded: {xc_diff} from "
                             "pair_xcorrs")
    stage["stages"] = round(w_st, 4)
    print(f"  identify_sharded {len(out['identify'][0])} hits == "
          f"identify_frames; render_hist_sharded {H}x{W}: {in_view} locs "
          f"in view == its sum == one shard's; pair_xcorrs_sharded "
          f"{len(out['pairs'][0])} pairs of {tuple(segs.shape)}: max |d| "
          f"{xc_diff:.3e} from pair_xcorrs ({'bit for bit' if xc_diff == 0 else 'cuFFT batches'}); "
          f"{w_st:.3f} s")

    # SPINNA: phase 19's cell-scale candidates
    mixer, gt = spinna_cell(spinna)
    rows = mixer.convert_N_structures_to_array(spinna.generate_N_structures(
        mixer.structures, {"A": sum(c * n for c, n in zip(
            SPINNA_CELL["counts"], (1, 2, 3)))}, SPINNA_GRANULARITY))
    scorer = spinna.SPINNA(mixer, gt, N_sim=SPINNA_NSIM,
                           device=one)._get_batched_scorer(rows)
    scores_1, w1, _ = counted(lambda: scorer.score(rows, MESH_SPINNA_SEED))
    scores_m, wm, paths["mesh-spinna"] = counted(
        lambda: pmesh.spinna_score_sharded(scorer, rows, MESH_SPINNA_SEED,
                                           mesh))
    if not np.array_equal(scores_m, scores_1):
        raise AssertionError("spinna_score_sharded != score")
    print(f"  spinna_score_sharded {len(rows)} candidates (N_sim "
          f"{SPINNA_NSIM}) == the scorer on one card bit for bit; mesh "
          f"{wm:.3f} s, one card {w1:.3f} s")

    # G5M: phase 18's origami, a bucket direct and g5m routed
    clustered, info, ids = origami
    sub = clustered[np.isin(clustered["group"], ids[:N_CARD_CPU])]
    preps = [g5m._prep_group(sub[sub["group"] == g], min_locs=g5m.MIN_LOCS,
                             pixelsize=130, max_locs_per_cluster=np.inf,
                             loc_prec_handle="local")
             for g in ids[:N_CARD_CPU]]
    preps = [p for p in preps if p is not None]
    bucket = max(len(p[0]) for p in preps)
    X, mask, lp = gmm.pad_clusters([p[0] for p in preps],
                                   [p[1] for p in preps], bucket)
    u = gmm.kmeans_uniforms(len(X), MESH_G5M_K, MESH_G5M_STARTS, 42)
    kw = dict(K=MESH_G5M_K, sigma_bounds=(g5m.MIN_SIGMA_FACTOR,
                                          g5m.MAX_SIGMA_FACTOR),
              isotropic=preps[0][2].isotropic, loc_local=True,
              min_locs=g5m.MIN_LOCS)
    got, wm, _ = counted(lambda: pmesh.fit_g5m_clusters_sharded(
        X, mask, lp, u, mesh=mesh, **kw))
    ref, w1, _ = counted(lambda: [a.cpu().numpy() for a in
                                  gmm.fit_g5m_batched(*(
                                      torch.from_numpy(a).to(one)
                                      for a in (X, mask, lp, u)), **kw)])
    if any(a.shape != b.shape for a, b in zip(got, ref)):
        raise AssertionError("fit_g5m_clusters_sharded: shapes differ")
    # the same draws, but the card's reductions over a cluster's points
    # may split by the batch's shape: reported here, gated by compare_g5m
    # on g5m below
    same = np.all([_rows_equal(a, b) for a, b in zip(got, ref)], axis=0)
    alike = (got[7] == ref[7]) & (got[6] == ref[6]).all(1)
    d_means = float(np.abs(got[1] - ref[1])[alike].max(initial=0.0))
    runs = {}
    for name, dev in (("mesh", mesh), ("one card", one)):
        r = {}
        res, w, launches = counted(lambda: g5m.g5m(
            sub, info, postprocess=False, device=dev, record=r))
        runs[name] = res[0], r, w
        if name == "mesh":
            paths["mesh-g5m"] = launches
    agree = compare_g5m(runs["mesh"][0], runs["mesh"][1],
                        runs["one card"][0], runs["one card"][1], sub,
                        what="G5M mesh vs one card")
    print(f"  fit_g5m_clusters_sharded {len(X)} clusters (bucket {bucket},"
          f" K {MESH_G5M_K}, {MESH_G5M_STARTS} starts) against "
          f"fit_g5m_batched on one card: {int(same.sum())} clusters bit for "
          f"bit, {int(alike.sum())} with the same valid components and ok, "
          f"their means at most {d_means:.3e} px apart (mesh {wm:.3f} s, "
          f"one card {w1:.3f} s); g5m on "
          f"{N_CARD_CPU} origami over the mesh {runs['mesh'][2]:.3f} s, one"
          f" card {runs['one card'][2]:.3f} s, compare_g5m: worst "
          f"{agree['worst_same']:.3e} px, stepped {agree['stepped']}, BIC "
          f"ties {agree['bic_ties']}")

    # (e) the dry run
    line, w, paths["mesh-dryrun"] = counted(
        lambda: dryrun_multichip(mesh.size, devices=list(mesh.devices)))
    print(f"  dry run {w:.3f} s")

    # each shard's outputs on its own card
    if distinct > 1:
        def where(i, lo, hi):
            chunk = pmesh.upload(identify.host_frames(movie[lo:hi]),
                                 mesh.devices[i])
            tiles = identify_cuda.identify_tiles(chunk, MIN_NG, BOX)
            return torch.cuda.current_device(), tiles[0].device

        made = mesh.run(where, *zip(*pmesh._split(CHUNK, mesh.size)))
        for d, (cur, dev) in zip(mesh.devices, made):
            if not (cur == d.index and dev == d):
                raise AssertionError(f"a shard of {d} ran on {cur}, {dev}")
        print(f"  each shard's outputs on its own card: {made}")
    else:
        print("  each shard's outputs on its own card: not checked (one "
              "card visible)")
    for name, launches in paths.items():
        if name.startswith("mesh-") and name not in (
                "mesh-fits", "mesh-fits-sigma", "mesh-stages",
                "mesh-dryrun") and any(launches.values()):
            raise AssertionError(f"path {name} launched {launches}")
    return paths


def watcher_phase(movie, counted, check_route, smi: str) -> dict:
    """24. The folder watcher on the card: the movie written as one
    movie.ome.tif in a temporary folder of the checkout, watched once
    with every count set to 0 just before; io.save_locs captured; the
    locs held bit for bit to a direct localize of the same file. Returns
    the launches."""
    from picasso_torch import io, localize
    from picasso_torch.server import watcher
    from torch_data import write_tiff

    camera = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    params = {"Min. Net Gradient": 5000, "Box Size": 7}
    split = dict.fromkeys(("discovery", "wait", "load", "localize"), 0.0)

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[name] += time.perf_counter() - t0
        return call

    saved = []
    keep = {(watcher, "check_new"): watcher.check_new,
            (watcher, "wait_for_change"): watcher.wait_for_change,
            (io, "load_movie"): io.load_movie,
            (localize, "localize"): localize.localize,
            (io, "save_locs"): io.save_locs}
    with tempfile.TemporaryDirectory(prefix=".smoke-watch-", dir=ROOT) as tmp:
        path = os.path.join(tmp, "movie.ome.tif")
        t0 = time.perf_counter()
        write_tiff(path, movie)
        t_write = time.perf_counter() - t0
        log = os.path.join(tmp, "watch.log")
        watcher.check_new = timed("discovery", keep[watcher, "check_new"])
        watcher.wait_for_change = timed("wait",
                                        keep[watcher, "wait_for_change"])
        io.load_movie = timed("load", keep[io, "load_movie"])
        localize.localize = timed("localize", keep[localize, "localize"])
        io.save_locs = lambda p, locs, info: saved.append((p, locs, info))
        try:
            _, wall, launches = counted(lambda: watcher.watch(
                tmp, logfile=log, poll_s=0, max_iterations=1,
                device="cuda"))
        finally:
            for (module, name), fn in keep.items():
                setattr(module, name, fn)
        with open(log) as f:
            lines = f.read().splitlines()
        src, movie_info = io.load_movie(path)
        direct, info = localize.localize(
            src, dict(camera), params, movie_info=movie_info,
            fitting_method="gaussmle", return_info=True, device="cuda")
    if (not any(" Processed " + path in ln for ln in lines)
            or any(" FAILED " in ln for ln in lines)):
        raise AssertionError(f"watcher log: {lines}")
    check_route("watcher", launches, "K5 mle queue", 2)
    if len(saved) != 1:
        raise AssertionError(f"watcher saved {len(saved)} files")
    out, locs, saved_info = saved[0]
    if out != os.path.splitext(path)[0] + "_locs.hdf5":
        raise AssertionError(f"watcher saved to {out}")
    if (len(locs) == 0 or locs.dtype != direct.dtype or saved_info != info
            or any(not np.array_equal(locs[n], direct[n], equal_nan=True)
                   for n in direct.dtype.names)):
        raise AssertionError("watcher locs differ from a direct localize")
    print(f"watcher ({smi}): {len(locs)} locs from {len(movie)} frames == a "
          f"direct localize bit for bit, saved as "
          f"{os.path.basename(out)}; wall {wall:.3f} s: discovery "
          f"{split['discovery']:.4f}, wait_for_change {split['wait']:.3f}, "
          f"load {split['load']:.4f}, localize {split['localize']:.3f} s "
          f"(the TIFF written in {t_write:.3f} s before); launches "
          f"{launches}")
    return launches


def _without_figure(cls, **state):
    """An app of picasso_torch.gui with ``state``, the state its
    constructor sets, but no figure: the constructors import matplotlib,
    which the card's machine does not have, so phase 25 calls the apps'
    methods that reach the device on an instance built without one."""
    app = cls.__new__(cls)
    app.__dict__.update(state)
    return app


def render_gui_phase(mle, lq, info, sites, counted, smi: str) -> dict:
    """25 (a). The render window's frame on the card (path
    ``render-gui``): RenderApp.render_scene on two channels, the
    undrifted MLE locs and the LQ slice's, as the app holds them (blur
    ``smooth``, oversampling 8, the whole field of view; channel colours
    LUTs of render.stops_to_lut, as a colormap by name wants matplotlib),
    then after one ZOOM_STEP zoom in (the app's dynamic oversampling);
    each frame's images within RENDER_AGREE of the CPU app's, the RGB
    within one level; the render window's painters (picks, points, a
    rectangular pick's corners, scale bar, legend, minimap) on the card's
    and the CPU's frames, their pixels equal; rgb_to_qimage raises
    without PyQt6. Returns the launches."""
    from picasso_torch import render
    from picasso_torch.gui import render_app

    info = [dict(info[0], Pixelsize=130)]
    luts = [render.stops_to_lut([(0.0, 0.0, 0.0, 0.0), (1.0, 1.0, 0.4, 0.1)]),
            render.stops_to_lut([(0.0, 0.0, 0.0, 0.0), (0.5, 0.1, 0.5, 0.6),
                                 (1.0, 0.3, 0.9, 1.0)])]
    t0 = time.perf_counter()
    channels = [render_app.Channel(locs, info) for locs in (mle, lq)]
    for ch, lut in zip(channels, luts):
        ch.color = lut
    t_index = time.perf_counter() - t0
    full = ((0.0, 0.0), (float(info[0]["Height"]), float(info[0]["Width"])))
    apps = {where: _without_figure(
        render_app.RenderApp, device=dev, channels=channels,
        current_channel=0, blur_method="smooth", colormap="hot",
        oversampling=8.0, dynamic_oversampling=True, min_blur_width=0.0,
        contrast=None, invert_colors=False, _fast_render_masks={},
        slicer_on=False, viewport=full)
        for where, dev in (("card", "cuda"), ("cpu", "cpu"))}
    images = []
    keep = render.scale_contrast

    def record(image, *a, **k):
        images.append(np.array(image))
        return keep(image, *a, **k)

    frames, walls, oversampling, runs = {}, {}, {}, []
    render.scale_contrast = record
    try:
        for view in ("full", "zoom"):
            for where, app in apps.items():
                if view == "zoom":
                    app.viewport = render.zoom_viewport(
                        app.viewport, 1 / render_app.ZOOM_STEP, None)
                    app._follow_zoom()
                if where == "card":
                    (rgb, n), wall, launches = counted(app.render_scene)
                    runs.append(launches)
                else:
                    t0 = time.perf_counter()
                    rgb, n = app.render_scene()
                    wall = time.perf_counter() - t0
                frames[view, where] = (rgb, n, images.pop())
                walls[view, where] = wall
                oversampling[view] = app.oversampling
    finally:
        render.scale_contrast = keep
    agree = RENDER_AGREE["smooth"]
    for view in ("full", "zoom"):
        (rgb_g, n_g, raw_g), (rgb_c, n_c, raw_c) = (frames[view, d]
                                                     for d in apps)
        rel = float(np.abs(raw_g - raw_c).max() / raw_c.max())
        d = np.abs(rgb_g.astype(int) - rgb_c)
        print(f"  render-gui {view}: {rgb_g.shape} of {n_g} locs, "
              f"oversampling {oversampling[view]:.4f}, card "
              f"{walls[view, 'card']:.3f} s (CPU {walls[view, 'cpu']:.3f} "
              f"s); images max|d|/max {rel:.3g}, RGB "
              f"{int(d.any(2).sum())} pixels differ by up to {int(d.max())}")
        if (n_g != n_c or raw_g.shape != raw_c.shape or rel > agree
                or d.max() > 1 or not raw_c.max() > 0):
            raise AssertionError(f"render-gui {view}: the card's frame is not"
                                 " the CPU's")
    # the painters on the zoomed frames of the card and of the CPU
    vp = apps["card"].viewport
    picks = [(float(c), float(r)) for r, c in sites[:64]]
    corners = render.get_rectangle_pick_polygon(100.0, 110.0, 150.0, 140.0,
                                                4.0)
    disp_px = 130 / apps["card"].oversampling
    colors = [tuple(int(v) for v in np.round(255 * lut[-1, :3]))
              for lut in luts]

    def paint(rgb):
        rgb = render.draw_picks(rgb, picks, 2.0, vp)
        rgb = render.draw_points(rgb, picks + corners, vp,
                                 color=(0, 255, 0))
        rgb = render.draw_scalebar(rgb, 130, disp_px)
        rgb = render.draw_legend(rgb, ["MLE", "LQ"], colors)
        return render.draw_minimap(rgb, vp, (256.0, 256.0))

    t0 = time.perf_counter()
    painted = {where: paint(frames["zoom", where][0]) for where in apps}
    t_paint = time.perf_counter() - t0
    shape = painted["card"].shape
    where = np.zeros(shape[:2], bool)
    for fill in (0, 255):
        plain = np.full(shape, fill, np.uint8)
        where |= (paint(plain) != plain).any(2)
    if not (where.sum() > 0 and np.array_equal(painted["card"][where],
                                               painted["cpu"][where])):
        raise AssertionError("render-gui: the painted pixels differ")
    try:
        render.rgb_to_qimage(painted["card"])
        raise AssertionError("render-gui: rgb_to_qimage did not raise")
    except ImportError:
        pass
    launches = _sum_launches(*runs)
    print(f"render-gui ({smi}): two channels of {len(mle)} + {len(lq)} locs,"
          f" index {t_index:.3f} s; {int(where.sum())} painted pixels equal "
          f"on the card's and the CPU's frames ({t_paint:.3f} s for both); "
          f"rgb_to_qimage raises ImportError; launches {launches}")
    return launches


def localize_gui_phase(movie, locs_lq, counted, n_chunks: int,
                       smi: str) -> dict:
    """25 (b). The movie browser's calls on the card at LocalizeApp's
    defaults (path ``localize-gui``): the preview (identify_current on
    frame 0 with an ROI) by compare_hits against the CPU's;
    localize_movie (gausslq, the app's camera, min. net gradient 5000,
    box 7) == the LQ slice of phase 6 on its hits above 5000 bit for bit
    (K5's LM fit is the same for a spot in any chunk); identify at the
    app's settings, then fit2D from those identifications (gausslq) ==
    K5's LM queue at fit2D's max_it 30 on the same hits bit for bit, as
    phase 10 holds it. Returns the launches."""
    import inspect

    import torch

    from picasso_torch import gausslq, localize
    from picasso_torch.gui import viewers
    from picasso_torch.gui.base import StatusLog
    from picasso_torch.ops import identify, lq, lq_cuda, winfit_cuda
    from torch_parity import compare_hits

    defaults = inspect.signature(viewers.LocalizeApp.__init__).parameters
    min_ng = defaults["min_net_gradient"].default
    box = defaults["box"].default
    info = [{"Frames": len(movie), "Height": movie.shape[1],
             "Width": movie.shape[2], "Pixelsize": 130}]
    roi = ((32, 48), (200, 224))
    apps = {where: _without_figure(
        viewers.LocalizeApp, movie=movie, info=info, device=dev,
        min_net_gradient=min_ng, box=box, frame_number=0, roi=None,
        contrast_percentiles=(0.5, 99.5),
        camera_info={"Baseline": 0.0, "Sensitivity": 1.0, "Gain": 1.0,
                     "Qe": 1.0, "Pixelsize": 130},
        fitting_method="gausslq", status=StatusLog())
        for where, dev in (("card", "cuda"), ("cpu", "cpu"))}
    app = apps["card"]
    for a in apps.values():  # set_roi without its redraw
        a.roi = roi
    (frame, x, y, ng), wall_p, run_p = counted(app.identify_current)
    _, xc, yc, ngc = apps["cpu"].identify_current()
    for a in apps.values():  # clear_roi without its redraw
        a.roi = None
    pairs = compare_hits([np.zeros(len(xc), int), yc, xc, ngc],
                         [np.zeros(len(x), int), y, x, ng], min_ng,
                         "localize-gui preview")
    (got, _), wall_l, run_l = counted(app.localize_movie)
    want = locs_lq[locs_lq["net_gradient"] > np.float32(min_ng)]
    if not (len(got) == len(want) > 0 and got.dtype == want.dtype and all(
            np.array_equal(got[c], want[c], equal_nan=True)
            for c in want.dtype.names)):
        raise AssertionError("localize-gui: localize_movie differs from the "
                             "LQ slice's locs above the app's gradient")
    ids, wall_i, run_i = counted(lambda: localize.identify(
        movie, min_ng, box, device="cuda"))
    (fit, _), wall_f, run_f = counted(lambda: localize.fit2D(
        movie, info, dict(app.camera_info), ids, box,
        fitting_method=app.fitting_method, device="cuda"))
    whole = identify.upload_frames(movie, torch.device("cuda"))
    hits = [torch.from_numpy(np.ascontiguousarray(ids[c])).to("cuda")
            for c in ("frame", "y", "x")]
    lq30 = winfit_cuda.fit_lq_queue_t(whole, *hits, 0.0, 1.0, box=box,
                                      max_it=30, ftol=FTOL).cpu().numpy()
    del whole, hits
    ref = gausslq.locs_from_fits(ids, lq30.T, box, False)
    if len(ids) != len(got) or any(
            not np.array_equal(fit[c], ref[c], equal_nan=True)
            for c in ref.dtype.names):
        raise AssertionError("localize-gui: fit2D differs from K5's LM queue "
                             "at max_it 30 on the same hits")
    # K4 once a chunk (the preview's one frame is one chunk), K5's LM
    # queue once a chunk of localize_movie, no other kernel
    for what, run, n_k5 in (("preview", run_p, 0), ("localize", run_l,
                                                    n_chunks),
                            ("identify", run_i, 0)):
        n_k4 = 1 if what == "preview" else n_chunks
        if (run["K4"] != n_k4 or run["K5 lq queue"] != n_k5 or any(
                v for k, v in run.items() if k not in ("K4", "K5 lq queue"))):
            raise AssertionError(f"localize-gui {what}: launches {run}")
    k3_key = "K3 queue" if lq_cuda.ROI_FIT is lq_cuda.fit_queue_t else "K3"
    if (run_f[k3_key] != -(-len(ids) // lq._CHUNK)
            or any(v for k, v in run_f.items() if k != k3_key)):
        raise AssertionError(f"localize-gui fit2D: launches {run_f}")
    launches = _sum_launches(run_p, run_l, run_i, run_f)
    print(f"localize-gui ({smi}), LocalizeApp's defaults (min. net gradient "
          f"{min_ng:g}, box {box}, {app.fitting_method}, camera "
          f"{app.camera_info}): preview of frame 0 in ROI {roi}: "
          f"{len(x)} spots, {len(pairs)} matched with the CPU's, "
          f"{wall_p * 1e3:.2f} ms; localize_movie {len(got)} locs in "
          f"{wall_l:.3f} s == the LQ slice's above {min_ng:g} bit for bit; "
          f"identify {wall_i:.3f} s; fit2D {wall_f:.3f} s == K5's LM queue at"
          f" max_it 30 bit for bit; launches {launches}")
    return launches


# phase 26: every box on the card. The wide movie
# (tests/torch_data.make_wide_movie: 2048 frames of 256 x 256, 100 sites
# at least 17 px apart, spots of 2.5 px over 17 x 17 px, ~100,000 of
# them) localized as WIDE_SLICES (path, box, method) with WIDE_MIN_NG
# (its spots' net gradient is ~11,000-11,800 at boxes 17 and 21, the
# background maxima's below 3,000); ANY_SPOTS make_spots a box of the
# bit-for-bit checks of the any-box bodies; the box whose kernels are
# timed on N_SPOTS make_spots
WIDE_SLICES = (("box17-mle", 17, "sigmaxy"), ("box17-mle-sigma", 17, "sigma"),
               ("box17-lq", 17, "lq"), ("box21-mle", 21, "sigmaxy"))
WIDE_MIN_NG = 5000
ANY_SPOTS = 8192
TIMED_BOX = 17
# boxes at which the any-box MLE queue is held to its one-thread pass
# (make_spots, ANY_SPOTS a box), and the box above the stage's shared
# memory (the pixels read from the batch) with its spots
QUEUE_BOXES = (4, 8, 16, 17, 21)
NO_STAGE_BOX, NO_STAGE_SPOTS = 45, 2048
# a box above the LM queue's last one whose group stages fit a block's
# shared bytes (ops/lq_cuda.anybox_queue_config: 117), held there on its
# spots
LQ_NO_STAGE_BOX, LQ_NO_STAGE_SPOTS = 120, 256
# boxes at which the tiled cut is held to its direct kernel and the
# plain version, u16 and f32 chunks
CUT_BOXES = (4, 7, 15, 17, 21)
# a box at which no tile of the any-box K4 fits (96 and above), on the
# wide chunk's first frames
NO_TILE_BOX, NO_TILE_FRAMES = 97, 4
# the separable maxima test's compares a tested pixel (csrc/
# identify_anybox.cu): along each axis the prefix and the suffix maxima
# and two window maxima (8), the whole row's (2), the centre's four
# comparisons (4)
K4_SEPARABLE_OPS = 14


def _plain_hits(movie, box: int, dev):
    """The plain versions of K4 and the cut on the card, chunk by chunk:
    (hits [frame, y, x, ng] numpy, the photon ROIs (S, S, N) of all
    chunks on the card, one batch)."""
    import torch

    from picasso_torch.ops import identify, winfit_cuda

    hits, rois = [], []
    for off in range(0, len(movie), CHUNK):
        frames = identify.upload_frames(movie[off:off + CHUNK], dev)
        f, y, x, ng = identify.compact(*identify.identify_tiles_plain(
            frames, WIDE_MIN_NG, box), box)
        rois.append(winfit_cuda.photons_t(frames, f, y, x, box, 0.0, 1.0))
        hits.append([a.cpu().numpy() for a in (f + off, y, x, ng)])
    return [np.concatenate(c) for c in zip(*hits)], torch.cat(rois, -1)


def _plain_fits(rois, method: str) -> list:
    """The plain fit of the ROIs as one batch (the plain fits are
    launch-bound: one call on all spots takes about what one chunk's
    does): numpy (theta, crlb, ll, iters), or for "lq" (theta, the
    ROIs)."""
    from picasso_torch.ops import fused, lq, mle

    return [a.cpu().numpy() for a in (
        (lq._lm_core(rois, MAX_IT, fused.LQ_FTOL), rois) if method == "lq"
        else mle._fit_core(rois, EPS, MAX_IT, method))]


def _locs_fields(locs) -> list:
    """(theta, crlb, ll, iters) rows-first of an MLE locs table (x/y in
    the frame, the CRLB from the uncertainties)."""
    return [np.stack([locs[c] for c in ("x", "y", "photons", "bg", "sx",
                                        "sy")]),
            np.stack([locs[c] for c in ("lpx", "lpy", "photons_unc",
                                        "bg_unc", "sx_unc", "sy_unc")]) ** 2,
            locs["log_likelihood"], locs["iterations"]]


# boxes 1 and 2 (phase 26 (c)): the MLE held to the plain fit at
# SMALL_MAX_IT (as box 3), the LM at fit2D's max_it; the bench movie's
# first SMALL_FRAMES frames give fit2D its box-3 identifications
SMALL_BOXES = (1, 2)
SMALL_MAX_IT, SMALL_LQ_IT, SMALL_FRAMES = 5, 30, CHUNK


def _hold_small_mle(sp, got, method: str, what: str) -> dict:
    """The any-box MLE queue's fit ``got`` of the box-1 or box-2 batch
    ``sp`` at SMALL_MAX_IT held to the plain fit as
    tests/test_torch_cuda.py holds it: at box 1 by compare_fits_max_it,
    at box 2 by compare_fits_rounding against the plain fit in f64.
    Returns the distances to the plain fit (``pair``) and, at box 2, to
    the fit in f64 (``got``) and the plain fit's (``ref``)."""
    from picasso_torch.ops import mle
    from torch_parity import compare_fits_max_it, compare_fits_rounding

    as_np = lambda out: [a.cpu().numpy() for a in out]  # noqa: E731
    plain = as_np(mle._fit_core(sp, EPS, SMALL_MAX_IT, method))
    if sp.shape[0] == 1:
        return {"pair": compare_fits_max_it(plain, got, SMALL_MAX_IT, what)}
    exact = as_np(mle._fit_core(sp.double(), EPS, SMALL_MAX_IT, method))
    return compare_fits_rounding(exact, plain, got, SMALL_MAX_IT, what)


def _hold_small_lq(sp, got, what: str) -> dict:
    """The any-box LM queue's fit ``got`` (theta at SMALL_LQ_IT) held to
    the plain fit: at box 1 bit for bit, at box 2 by
    compare_lq_fits_rounding against the plain fit in f64. Returns the
    distances as :func:`_hold_small_mle` does."""
    from picasso_torch.ops import lq
    from torch_parity import compare_lq_fits_rounding

    plain = lq._lm_core(sp, SMALL_LQ_IT, FTOL).cpu().numpy()
    if sp.shape[0] == 1:
        if not np.array_equal(got, plain, equal_nan=True):
            raise AssertionError(f"{what}: not the plain fit bit for bit")
        return {"pair": {"xy_p100": 0.0}}
    exact = lq._lm_core(sp.double(), SMALL_LQ_IT, FTOL).cpu().numpy()
    return compare_lq_fits_rounding(exact, plain, got,
                                    sp.double().cpu().numpy(), what)


def small_box_phase(bench, counted, smi: str):
    """26 (c). Boxes 1 and 2 on the card, at each: gaussmle (sigmaxy,
    sigma) and gausslq on make_spots(N_SPOTS, box, 0), and fit2D (MLE,
    LQ, avg) of the ROIs of the bench movie's box-3 identifications on
    its first SMALL_FRAMES frames, through the entry points with their
    launches counted (paths ``box1-mle``, ``box1-mle-sigma``,
    ``box1-lq``, ``box1-fit2D-mle``, ``box1-fit2D-lq``,
    ``box1-fit2D-avg``, and ``box2-*``); each fit == the any-box one-thread
    pass bit for bit, the queues held to the plain fits at SMALL_MAX_IT
    (MLE) and SMALL_LQ_IT (LM) by the tests' comparisons (box 1:
    compare_fits_max_it, the LM bit for bit; box 2: against the plain
    fit in f64, compare_fits_rounding / compare_lq_fits_rounding), avg
    within compare_avg_photons; the tiled cut == its direct kernel ==
    photons_t (u16, f32); identify raises a ValueError at the box; the
    MLE queue (both methods) and the LM queue timed in turns with their
    one-thread passes, the cut with its direct kernel. Returns (launches
    by path, ms, bounds, errs, a summary a box)."""
    import torch

    from picasso_torch import avgroi, gausslq, gaussmle, localize
    from picasso_torch.ops import lq, lq_cuda, mle, mle_cuda, winfit_cuda
    from torch_data import make_spots, spots_chunk
    from torch_parity import compare_avg_photons

    dev = torch.device("cuda")
    as_np = lambda out: [a.cpu().numpy() for a in out]  # noqa: E731
    camera = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    frames = bench[:SMALL_FRAMES]
    info = [{"Frames": len(frames), "Height": frames.shape[1],
             "Width": frames.shape[2]}]
    ids = localize.identify(frames, MIN_NG, 3, device="cuda")
    paths, ms, bounds, errs, summary = {}, {}, {}, {}, {}
    n = N_SPOTS

    def only(launches, keys, what):
        on = {k for k, v in launches.items() if v}
        if on != set(keys):
            raise AssertionError(f"{what} did not run through {keys} "
                                 f"only: {launches}")

    for box in SMALL_BOXES:
        tag = f"box{box}"
        got_box = summary[tag] = {"ids": len(ids)}
        spots = make_spots(n, box, seed=0)
        sp = torch.from_numpy(np.ascontiguousarray(
            spots.transpose(1, 2, 0))).to(dev)
        # (1) the entry points, counted; each == the one-thread pass
        for method in ("sigmaxy", "sigma"):
            path = f"{tag}-mle" + ("-sigma" if method == "sigma" else "")
            out, wall, paths[path] = counted(lambda: gaussmle.gaussmle(
                spots, EPS, MAX_IT, method, device="cuda"))
            only(paths[path], ["mle anybox"], path)
            one = as_np(mle_cuda.fit_anybox_one_pass_t(sp, EPS, MAX_IT,
                                                       method))
            _assert_equal([out[0].T, out[1].T, out[2], out[3]], one,
                          f"{path}: gaussmle vs the one-thread pass")
            sig = " sigma" if method == "sigma" else ""
            key, one_key = "mle anybox" + sig, "mle anybox one pass" + sig
            st = _hold_small_mle(sp, as_np(mle_cuda.fit_anybox_t(
                sp, EPS, SMALL_MAX_IT, method)), method, f"{path} vs plain")
            errs[f"{key} {tag}"] = errs[f"{one_key} {tag}"] = \
                st["pair"]["xy_p100"]
            got_box[path] = {"s": round(wall, 4), "at_max_it": float(
                np.mean(one[3] == MAX_IT)), "held": st}
            # in turns with the one-thread pass; the plain fit once
            one_t, queue_t = _alternate((
                lambda: mle_cuda.fit_anybox_one_pass_t(sp, EPS, MAX_IT,
                                                       method),
                lambda: mle_cuda.fit_anybox_t(sp, EPS, MAX_IT, method)))
            ms[f"{key} {tag}"] = statistics.median(queue_t)
            ms[f"{one_key} {tag}"] = statistics.median(one_t)
            _, ms[f"plain {key} {tag}"] = _once_ms(
                lambda: mle._fit_core(sp, EPS, MAX_IT, method))
            ms[f"plain {one_key} {tag}"] = ms[f"plain {key} {tag}"]
            bounds[f"{key} {tag}"] = bounds[f"{one_key} {tag}"] = _fit_bound(
                n, float(one[3].sum()), mle_flops_per_spot_iter,
                6 * 4 * 2 + 8, box * box * 4, box)
        theta, wall, paths[f"{tag}-lq"] = counted(lambda: gausslq.fit_spots(
            spots, device="cuda"))
        only(paths[f"{tag}-lq"], ["lq anybox"], f"{tag}-lq")
        one = lq_cuda.fit_anybox_one_pass_t(sp, SMALL_LQ_IT).cpu().numpy()
        _assert_equal([theta.T], [one], f"{tag}-lq: fit_spots vs the "
                      "one-thread pass")
        st = _hold_small_lq(sp, one, f"{tag}-lq vs plain")
        errs[f"lq anybox {tag}"] = errs[f"lq anybox one pass {tag}"] = \
            st["pair"]["xy_p100"]
        got_box[f"{tag}-lq"] = {"s": round(wall, 4), "held": st}
        one_t, queue_t = _alternate((
            lambda: lq_cuda.fit_anybox_one_pass_t(sp, SMALL_LQ_IT),
            lambda: lq_cuda.fit_anybox_t(sp, SMALL_LQ_IT)))
        ms[f"lq anybox {tag}"] = statistics.median(queue_t)
        ms[f"lq anybox one pass {tag}"] = statistics.median(one_t)
        steps, _, reused = lq_iters(sp, SMALL_LQ_IT)
        _, ms[f"plain lq anybox {tag}"] = _once_ms(
            lambda: lq._lm_core(sp, SMALL_LQ_IT, FTOL), warm=False)
        ms[f"plain lq anybox one pass {tag}"] = ms[f"plain lq anybox {tag}"]
        bounds[f"lq anybox {tag}"] = bounds[f"lq anybox one pass {tag}"] = \
            lq_fit_bound(n, float(steps.sum()), float(reused.sum()),
                         box * box * 4, box)
        # (2) fit2D of the bench movie's box-3 identifications
        rois = localize.get_spots(frames, ids, box, dict(camera),
                                  device="cuda")
        rt = torch.from_numpy(np.ascontiguousarray(
            rois.transpose(1, 2, 0))).to(dev)
        for method, key in (("gaussmle", "mle anybox"),
                            ("gausslq", "lq anybox"), ("avg", None)):
            path = f"{tag}-fit2D-{method[5:] if key else 'avg'}"
            (locs, _), wall, paths[path] = counted(lambda: localize.fit2D(
                frames, info, dict(camera), ids, box, fitting_method=method,
                device="cuda"))
            only(paths[path], [key] if key else [], path)
            if method == "gaussmle":
                one = as_np(mle_cuda.fit_anybox_one_pass_t(rt, EPS, MAX_IT))
                ref = gaussmle.locs_from_fits(ids, one[0].T, one[1].T,
                                              one[2], one[3], box)
                st = _hold_small_mle(rt, as_np(mle_cuda.fit_anybox_t(
                    rt, EPS, SMALL_MAX_IT)), "sigmaxy", f"{path} vs plain")
            elif method == "gausslq":
                one = lq_cuda.fit_anybox_one_pass_t(rt, SMALL_LQ_IT)
                ref = gausslq.locs_from_fits(ids, one.cpu().numpy().T, box,
                                             False)
                st = _hold_small_lq(rt, one.cpu().numpy(), f"{path} vs "
                                    "plain")
            else:
                ref = avgroi.locs_from_fits(ids, avgroi.fit_spots(
                    rois, device="cpu"), box, False)
                st = {"photons_rel": compare_avg_photons(
                    ref["photons"], locs["photons"], rois, path)}
                for c in ("x", "y", "sx", "sy"):
                    if not np.array_equal(locs[c], ref[c]):
                        raise AssertionError(f"{path}: {c} differs")
                ref = None
            if ref is not None and not all(
                    np.array_equal(locs[c], ref[c], equal_nan=True)
                    for c in ref.dtype.names):
                raise AssertionError(f"{path}: fit2D's locs are not the "
                                     "one-thread pass's bit for bit")
            got_box[path] = {"locs": len(locs), "s": round(wall, 4),
                             "held": st}
        # (3) the tiled cut == its direct kernel == photons_t
        for dtype in (np.uint16, np.float32):
            chunk, hits = spots_chunk(spots, dtype)
            chunk = torch.from_numpy(chunk).to(dev)
            hits = [torch.from_numpy(h).to(dev) for h in hits]
            cut = winfit_cuda.cut_anybox_t(chunk, *hits, box, 1.5, 0.8)
            for other, what in (
                    (winfit_cuda.cut_anybox_direct_t, "its direct kernel"),
                    (winfit_cuda.photons_t, "the plain version")):
                if not torch.equal(cut, other(chunk, *hits, box, 1.5, 0.8)):
                    raise AssertionError(
                        f"the tiled cut at box {box} ({dtype.__name__}) is "
                        f"not {what} bit for bit")
        # timed on the u16 chunk, as the path cuts it
        chunk = torch.from_numpy(spots_chunk(spots, np.uint16)[0]).to(dev)
        direct_t, tiled_t = _alternate((
            lambda: winfit_cuda.cut_anybox_direct_t(chunk, *hits, box, 0.0,
                                                    1.0),
            lambda: winfit_cuda.cut_anybox_t(chunk, *hits, box, 0.0, 1.0)))
        ms[f"cut anybox {tag}"] = statistics.median(tiled_t)
        ms[f"cut anybox direct {tag}"] = statistics.median(direct_t)
        _, ms[f"plain cut anybox {tag}"] = _once_ms(
            lambda: winfit_cuda.photons_t(chunk, *hits, box, 0.0, 1.0))
        ms[f"plain cut anybox direct {tag}"] = ms[f"plain cut anybox {tag}"]
        bounds[f"cut anybox {tag}"] = bounds[f"cut anybox direct {tag}"] = \
            _bound(2 * n * box * box, n * (box * box * 6 + 24))
        errs[f"cut anybox {tag}"] = errs[f"cut anybox direct {tag}"] = 0.0
        # (4) identify refuses the box on the card, as picasso_tpu's
        try:
            localize.identify(frames[:4], MIN_NG, box, device="cuda")
        except ValueError as e:
            got_box["identify"] = str(e)
        else:
            raise AssertionError(f"identify took box {box} on the card")
        for key, one_key in (
                ("mle anybox", "mle anybox one pass"),
                ("mle anybox sigma", "mle anybox one pass sigma"),
                ("lq anybox", "lq anybox one pass"),
                ("cut anybox", "cut anybox direct")):
            print(f"{key} at box {box}: {ms[f'{key} {tag}']:.4f} ms, "
                  f"{one_key} {ms[f'{one_key} {tag}']:.4f} ms (in turns), "
                  f"plain {ms[f'plain {key} {tag}']:.3f} ms, bound "
                  f"{bounds[f'{key} {tag}'][0]:.4f} ms "
                  f"({bounds[f'{key} {tag}'][1]}, "
                  f"{bounds[f'{key} {tag}'][0] / ms[f'{key} {tag}']:.1%} of "
                  f"it) ({smi})")
        del sp, rt, chunk, hits, cut
        print(f"box {box}: the entry points through the any-box kernels, "
              "each == the one-thread pass, the tiled cut == its direct "
              "kernel == plain (u16, f32), identify refused:",
              json.dumps(got_box), f"({smi})")
    return paths, ms, bounds, errs, summary


def anybox_phase(wide, chunk, timed_spots, bench, counted, smi: str):
    """26. Every box on the card. (a) localize at box 17 (MLE sigmaxy,
    sigma, LQ) and 21 (MLE) on the wide movie, each through K4 at any box
    (csrc/identify_anybox.cu), the any-box cut (cut_anybox.cu) and fit
    (mle_anybox_queue.cu, lq_anybox_queue.cu) with their launches
    counted, its hits and fits held to the plain versions on the card
    (compare_hits, compare_fits / compare_lq_fits); fit2D at box 17 on
    the MLE slice's identifications, both fitters, held likewise; the
    box-17 MLE and LQ chains split a chunk. (b) bit for bit: the any-box
    MLE queue == its one-thread pass at QUEUE_BOXES and NO_STAGE_BOX,
    the LM queue == its one-thread pass there and at LQ_NO_STAGE_BOX, the
    tiled cut == its direct kernel == photons_t at CUT_BOXES, the any-box bodies
    == the templated queues at 5-15, K4 at any box == identify.cu at 3-15
    on phase 3's chunk and == its direct kernel at 4, 17 and 21 on the
    wide chunk (within compare_tiles of the plain version there), K4 at
    NO_TILE_BOX (the direct kernel, no tile fitting) within compare_tiles
    of the plain version, the any-box cut + fit == K5 at 7 and 15, and
    box 3's K1, K2, K7, K3, K6
    and K5 == the one-thread passes, held to the plain fits by
    compare_fits_max_it and compare_lq_fits' box-3 bounds.
    ``timed_spots``: make_spots(N_SPOTS, TIMED_BOX, seed=0), on which the
    any-box kernels are timed (made alongside the build), the MLE and LM
    queues in turns with their one-thread passes, the cut and K4 with
    their direct kernels.
    Returns (launches by path, ms, bounds, errors) of the kernels
    line."""
    import torch

    from picasso_torch import gausslq, gaussmle, localize
    from picasso_torch.ops import (
        fused, identify, identify_cuda, lq, lq_cuda, mle, mle_cuda,
        winfit_cuda,
    )
    from torch_data import make_spots, spots_chunk
    from torch_parity import (
        STUCK_XY_MAX_BOX17, compare_fits, compare_fits_max_it, compare_hits,
        compare_lq_fits, compare_tiles,
    )

    dev = torch.device("cuda")
    as_np = lambda out: [a.cpu().numpy() for a in out]  # noqa: E731
    camera = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    info = [{"Frames": len(wide), "Height": wide.shape[1],
             "Width": wide.shape[2]}]
    n_chunks = -(-len(wide) // CHUNK)
    paths, ms, bounds, errs = {}, {}, {}, {}
    t0 = time.perf_counter()

    # (a) the slices ------------------------------------------------------
    kernel_ids, plain_hits = {}, {}
    for path, box, method in WIDE_SLICES:
        kw = dict(fitting_method="gausslq" if method == "lq" else "gaussmle",
                  mle_method="sigmaxy" if method == "lq" else method)
        params = {"Min. Net Gradient": WIDE_MIN_NG, "Box Size": box}
        # the chain's (ids, fits) of this very run, caught on their way
        # from ops/fused.localize_fused to localize's locs
        chain, real = [], fused.localize_fused

        def caught(*a, **k):
            chain.append(real(*a, **k))
            return chain[-1]

        fused.localize_fused = caught
        try:
            locs, wall, launches = counted(lambda: localize.localize(
                wide, dict(camera), params, device="cuda", **kw))
        finally:
            fused.localize_fused = real
        fit = "lq anybox" if method == "lq" else "mle anybox"
        on = {k for k, v in launches.items() if v}
        if on != {"K4 anybox", "cut anybox", fit} or any(
                launches[k] != n_chunks for k in on):
            raise AssertionError(f"box {box} {method} slice did not run "
                                 f"through the any-box kernels: {launches}")
        if len(chain) != 1:
            raise AssertionError(f"box {box} {method}: localize called "
                                 f"localize_fused {len(chain)} times")
        ids, fits = chain[0]
        t_p = time.perf_counter()
        if box not in plain_hits:
            plain_hits[box] = _plain_hits(wide, box, dev)
        plain_fits = _plain_fits(plain_hits[box][1], method)
        t_p = time.perf_counter() - t_p
        cols = ("frame", "y", "x", "net_gradient")
        pairs = compare_hits(plain_hits[box][0], [ids[c] for c in cols],
                             WIDE_MIN_NG, f"box {box} {method} hits")
        pi, ki = pairs[:, 0], pairs[:, 1]
        offset = 0 if method == "lq" else box // 2
        if len(locs) != len(ids) or not np.array_equal(
                locs["x"], (fits[0][:, 0] + ids["x"] - offset).astype(
                    np.float32)):
            raise AssertionError(f"box {box} {method}: localize's locs are "
                                 "not the chain's")
        if method == "lq":
            st = compare_lq_fits(plain_fits[0][:, pi], fits[0][ki].T,
                                 plain_fits[1][..., pi], f"box {box} lq")
            errs[path] = st["xy_p100"]
        else:
            st = compare_fits([plain_fits[0][:, pi], plain_fits[1][:, pi],
                               plain_fits[2][pi], plain_fits[3][pi]],
                              [fits[0][ki].T, fits[1][ki].T, fits[2][ki],
                               fits[3][ki]], MAX_IT, f"box {box} {method}")
            errs[path] = st["xy_max_all"]
        paths[path] = launches
        kernel_ids[path] = ids
        del plain_fits
        print(f"box {box} {method} slice: {len(locs)} locs from {len(wide)} "
              f"frames in {wall:.3f} s = {len(wide) / wall:.1f} frames/s, "
              f"{len(locs) / wall:.0f} spots/s; any-box launches "
              f"{ {k: launches[k] for k in sorted(on)} }; hits == plain "
              f"({len(pairs)}; the plain versions {t_p:.1f} s), fits vs "
              f"plain: {json.dumps(st)} ({smi})")
    del plain_hits
    torch.cuda.empty_cache()
    # fit2D at box 17 on the MLE slice's identifications, both fitters
    ids, box = kernel_ids["box17-mle"], 17
    spots = localize.get_spots(wide, ids, box, dict(camera), device="cuda")
    sp = torch.from_numpy(np.ascontiguousarray(
        spots.transpose(1, 2, 0))).to(dev)
    for method in ("gaussmle", "gausslq"):
        (locs, _), wall, launches = counted(lambda: localize.fit2D(
            wide, info, dict(camera), ids, box, fitting_method=method,
            device="cuda"))
        fit = "lq anybox" if method == "gausslq" else "mle anybox"
        on = {k for k, v in launches.items() if v}
        if on != {fit}:
            raise AssertionError(f"fit2D {method} at box {box} did not run "
                                 f"through the any-box fit: {launches}")
        t_p = time.perf_counter()
        if method == "gaussmle":
            th, cr, ll, it = as_np(mle._fit_core(sp, EPS, MAX_IT))
            ref = gaussmle.locs_from_fits(ids, th.T, cr.T, ll, it, box)
            st = compare_fits(_locs_fields(ref), _locs_fields(locs), MAX_IT,
                              f"fit2D {method} box {box}")
            errs["fit2D-mle"] = st["xy_max_all"]
        else:
            th = lq._lm_core(sp, 30, FTOL).cpu().numpy()
            ref = gausslq.locs_from_fits(ids, th.T, box, False)

            def rel(t):
                return np.stack([t["x"] - ids["x"], t["y"] - ids["y"],
                                 t["photons"], t["bg"], t["sx"],
                                 t["sy"]]).astype(np.float32)

            st = compare_lq_fits(rel(ref), rel(locs), sp.cpu().numpy(),
                                 f"fit2D {method} box {box}")
            errs["fit2D-lq"] = st["xy_p100"]
        t_p = time.perf_counter() - t_p
        paths[f"box{box}-fit2D-{method[5:]}"] = launches
        print(f"fit2D {method} at box {box}: {len(locs)} locs in {wall:.3f} s"
              f" = {len(locs) / wall:.0f} spots/s; launches "
              f"{ {k: launches[k] for k in sorted(on)} }; vs plain ("
              f"{t_p:.1f} s) {json.dumps(st)} ({smi})")
    del sp, spots
    # the box-17 MLE and LQ chains split a chunk: each stage of each
    # chunk of the wide movie alone (the CUDA-event timing of a second
    # call, after one on the same input), as ops/fused runs it at a box
    # without a template; both fits on the same cut
    box, split = 17, {k: [] for k in ("upload", "K4", "compaction", "cut",
                                      "fit", "fit lq")}
    for off in range(0, len(wide), CHUNK):
        host = wide[off:off + CHUNK]
        frames, t = _once_ms(lambda: identify.upload_frames(host, dev),
                             warm=True)
        split["upload"].append(t)
        tiles, t = _once_ms(lambda: identify_cuda.identify_tiles(
            frames, WIDE_MIN_NG, box), warm=True)
        split["K4"].append(t)
        hits, t = _once_ms(lambda: identify.compact(*tiles, box),
                           warm=True)
        split["compaction"].append(t)
        rois, t = _once_ms(lambda: winfit_cuda.cut_anybox_t(
            frames, *hits[:3], box, 0.0, 1.0), warm=True)
        split["cut"].append(t)
        _, t = _once_ms(lambda: mle_cuda.fit_anybox_t(rois, EPS, MAX_IT),
                        warm=True)
        split["fit"].append(t)
        _, t = _once_ms(lambda: lq_cuda.fit_anybox_t(rois, MAX_IT,
                                                     fused.LQ_FTOL),
                        warm=True)
        split["fit lq"].append(t)
    del frames, tiles, hits, rois
    for chain, fit in (("MLE", "fit"), ("LQ", "fit lq")):
        cols = ("upload", "K4", "compaction", "cut", fit)
        print(f"box {box} {chain} chain a chunk (ms, chunks 0-"
              f"{n_chunks - 1}; mean):",
              json.dumps({k.split()[0]: [[round(t, 4) for t in split[k]],
                                         round(float(np.mean(split[k])), 4)]
                          for k in cols}), f"({smi})")
    t_a = time.perf_counter()

    # (b) bit for bit -----------------------------------------------------
    # the any-box MLE queue == its one-thread pass; at NO_STAGE_BOX its
    # slots read the pixels from the batch
    for box in (*QUEUE_BOXES, NO_STAGE_BOX):
        n_any = NO_STAGE_SPOTS if box == NO_STAGE_BOX else ANY_SPOTS
        stage = mle_cuda.anybox_queue_config(box)["stage"]
        if (stage == "shared") != (box != NO_STAGE_BOX):
            raise AssertionError(f"the any-box queue's stage at box {box}: "
                                 f"{stage}")
        sp = torch.from_numpy(np.ascontiguousarray(make_spots(
            n_any, box, seed=box).transpose(1, 2, 0))).to(dev)
        for method in ("sigmaxy", "sigma"):
            _assert_equal(as_np(mle_cuda.fit_anybox_t(sp, EPS, MAX_IT,
                                                      method)),
                          as_np(mle_cuda.fit_anybox_one_pass_t(
                              sp, EPS, MAX_IT, method)),
                          f"mle anybox queue {method} vs the one-thread "
                          f"pass at box {box}")
    # the any-box LM queue == its one-thread pass (with lanes at n_valid
    # and beyond starting done in tests/test_torch_cuda.py); at
    # LQ_NO_STAGE_BOX its groups read the pixels from the batch
    for box in (*QUEUE_BOXES, NO_STAGE_BOX, LQ_NO_STAGE_BOX):
        n_any = LQ_NO_STAGE_SPOTS if box == LQ_NO_STAGE_BOX else ANY_SPOTS
        stage = lq_cuda.anybox_queue_config(box)["stage"]
        if (stage == "shared") != (box != LQ_NO_STAGE_BOX):
            raise AssertionError(f"the any-box LM queue's stage at box "
                                 f"{box}: {stage}")
        sp = torch.from_numpy(np.ascontiguousarray(make_spots(
            n_any, box, seed=box).transpose(1, 2, 0))).to(dev)
        _assert_equal([lq_cuda.fit_anybox_t(sp, MAX_IT).cpu().numpy()],
                      [lq_cuda.fit_anybox_one_pass_t(sp, MAX_IT).cpu(
                      ).numpy()], f"lq anybox queue vs the one-thread pass "
                      f"at box {box}")
    del sp
    for box in (5, 7, 9, 11, 13, 15):
        sp = torch.from_numpy(np.ascontiguousarray(make_spots(
            ANY_SPOTS, box, seed=box).transpose(1, 2, 0))).to(dev)
        for method in ("sigmaxy", "sigma"):
            k1 = as_np(mle_cuda.fit_t(sp, EPS, MAX_IT, method))
            for fit in (mle_cuda.fit_anybox_t, mle_cuda.fit_anybox_one_pass_t):
                _assert_equal(as_np(fit(sp, EPS, MAX_IT, method)), k1,
                              f"{fit.__name__} {method} vs K1 at box {box}")
        k3 = [lq_cuda.fit_queue_t(sp, MAX_IT).cpu().numpy()]
        for fit in (lq_cuda.fit_anybox_t, lq_cuda.fit_anybox_one_pass_t):
            _assert_equal([fit(sp, MAX_IT).cpu().numpy()], k3,
                          f"lq {fit.__name__} vs K3's queue at box {box}")
    for box in identify_cuda.BOXES:
        _assert_equal(as_np(identify_cuda.identify_tiles_anybox(chunk, MIN_NG,
                                                                box)),
                      as_np(identify_cuda.identify_tiles(chunk, MIN_NG, box)),
                      f"K4 anybox vs K4 at box {box}")
    first = identify.upload_frames(wide[:CHUNK], dev)
    for box in (4, 17, 21):
        tiles = as_np(identify_cuda.identify_tiles_anybox(first, WIDE_MIN_NG,
                                                          box))
        _assert_equal(tiles, as_np(identify_cuda.identify_tiles_anybox_direct(
            first, WIDE_MIN_NG, box)), f"K4 anybox vs its direct kernel at "
                          f"box {box}")
        compare_tiles(tiles, as_np(identify.identify_tiles_plain(
            first, WIDE_MIN_NG, box)), f"K4 anybox vs plain at box {box}")
    # a box at which no tile of the any-box K4 fits in a block's shared
    # memory: identify_tiles takes the direct kernel
    big = first[:NO_TILE_FRAMES]
    if identify_cuda.anybox_tile_fits(NO_TILE_BOX):
        raise AssertionError(f"a K4 tile fits box {NO_TILE_BOX}")
    compare_tiles(as_np(identify_cuda.identify_tiles(big, WIDE_MIN_NG,
                                                     NO_TILE_BOX)),
                  as_np(identify.identify_tiles_plain(big, WIDE_MIN_NG,
                                                      NO_TILE_BOX)),
                  f"K4 (the direct kernel) vs plain at box {NO_TILE_BOX}")
    del big
    # the tiled cut == its direct kernel == the plain version
    for box in CUT_BOXES:
        for dtype in (np.uint16, np.float32):
            frames, hits = spots_chunk(make_spots(ANY_SPOTS, box,
                                                  seed=box + 2), dtype)
            frames = torch.from_numpy(frames).to(dev)
            hits = [torch.from_numpy(h).to(dev) for h in hits]
            cut = winfit_cuda.cut_anybox_t(frames, *hits, box, 1.5, 0.8)
            for other, what in (
                    (winfit_cuda.cut_anybox_direct_t, "its direct kernel"),
                    (winfit_cuda.photons_t, "the plain version")):
                if not torch.equal(cut, other(frames, *hits, box, 1.5, 0.8)):
                    raise AssertionError(
                        f"the tiled cut at box {box} ({dtype.__name__}) is "
                        f"not {what} bit for bit")
    for box in (7, 15):
        frames, hits = spots_chunk(make_spots(ANY_SPOTS, box, seed=box + 1),
                                   np.uint16)
        frames = torch.from_numpy(frames).to(dev)
        hits = [torch.from_numpy(h).to(dev) for h in hits]
        cut = winfit_cuda.cut_anybox_t(frames, *hits, box, 1.5, 0.8)
        for method in ("sigmaxy", "sigma"):
            _assert_equal(as_np(mle_cuda.fit_anybox_t(cut, EPS, MAX_IT,
                                                      method)),
                          as_np(winfit_cuda.fit_mle_queue_t(
                              frames, *hits, 1.5, 0.8, box=box, eps=EPS,
                              max_it=MAX_IT, method=method)),
                          f"cut + mle anybox {method} vs K5 at box {box}")
        _assert_equal([lq_cuda.fit_anybox_t(cut, MAX_IT).cpu().numpy()],
                      [winfit_cuda.fit_lq_queue_t(
                          frames, *hits, 1.5, 0.8, box=box,
                          max_it=MAX_IT).cpu().numpy()],
                      f"cut + lq anybox vs K5 at box {box}")
    # box 3: every templated kernel == the one-thread passes
    spots3 = make_spots(N_SPOTS, 3, seed=0)
    sp = torch.from_numpy(np.ascontiguousarray(
        spots3.transpose(1, 2, 0))).to(dev)
    frames, hits = spots_chunk(spots3, np.uint16)
    frames = torch.from_numpy(frames).to(dev)
    hits = [torch.from_numpy(h).to(dev) for h in hits]
    box3 = {}
    for method in ("sigmaxy", "sigma"):
        one = as_np(mle_cuda.fit_one_pass_t(sp, EPS, MAX_IT, method))
        if method == "sigmaxy":
            iters3 = float(one[3].sum())
        kw = dict(box=3, eps=EPS, max_it=MAX_IT, method=method)
        for name, out in (
                ("K1", mle_cuda.fit_t(sp, EPS, MAX_IT, method)),
                ("K2", mle_cuda.fit_boundary_t(sp, EPS, MAX_IT, method)),
                ("K5 queue", winfit_cuda.fit_mle_queue_t(frames, *hits, 0.0,
                                                         1.0, **kw)),
                ("K5 phases", winfit_cuda.fit_mle_boundary_t(
                    frames, *hits, 0.0, 1.0, **kw)),
                ("K5 one pass", winfit_cuda.fit_mle_t(frames, *hits, 0.0,
                                                      1.0, **kw))):
            _assert_equal(as_np(out), one, f"box 3 {name} {method}")
        box3[method] = compare_fits_max_it(
            as_np(mle._fit_core(sp, EPS, 5, method)),
            as_np(mle_cuda.fit_t(sp, EPS, 5, method)), 5,
            f"box 3 K1 {method} vs plain")
        box3[method + " at max_it"] = float(np.mean(one[3] == MAX_IT))
    _assert_equal(as_np(mle_cuda.fit_multiround_t(sp, EPS, MAX_IT)),
                  as_np(mle_cuda.fit_one_pass_t(sp, EPS, MAX_IT)),
                  "box 3 K7")
    # box 3's K1 (sigmaxy) and K3 queue: their plain fits and bounds
    _, ms["plain K1 box 3"] = _once_ms(lambda: mle._fit_core(sp, EPS, MAX_IT))
    bounds["K1 box 3"] = _fit_bound(N_SPOTS, iters3, mle_flops_per_spot_iter,
                                    6 * 4 * 2 + 8, 3 * 3 * 4, 3)
    # lq_iters runs the plain LM's steps on this batch: the timed plain
    # call after it is warm
    steps, _, reused = lq_iters(sp, MAX_IT)
    plain_lq, ms["plain K3 queue box 3"] = _once_ms(
        lambda: lq._lm_core(sp, MAX_IT, FTOL), warm=False)
    bounds["K3 queue box 3"] = lq_fit_bound(N_SPOTS, float(steps.sum()),
                                            float(reused.sum()), 3 * 3 * 4, 3)
    k3 = lq_cuda.fit_t(sp, MAX_IT).cpu().numpy()
    for name, out in (("K3 queue", lq_cuda.fit_queue_t(sp, MAX_IT)),
                      ("K6", lq_cuda.fit_boundary_t(sp, MAX_IT)),
                      ("K5 lq queue", winfit_cuda.fit_lq_queue_t(
                          frames, *hits, 0.0, 1.0, box=3, max_it=MAX_IT))):
        _assert_equal([out.cpu().numpy()], [k3], f"box 3 {name}")
    box3["lq"] = compare_lq_fits(plain_lq.cpu().numpy(), k3,
                                 spots3.transpose(1, 2, 0), "box 3 K3",
                                 box3=True)
    # the any-box bodies take box 3 too: equal there, and timed in two
    # turns with the templated kernels that box 3 is routed to (the
    # lesser median of each)
    _assert_equal(as_np(mle_cuda.fit_anybox_t(sp, EPS, MAX_IT)),
                  as_np(mle_cuda.fit_one_pass_t(sp, EPS, MAX_IT)),
                  "box 3 mle anybox")
    _assert_equal([lq_cuda.fit_anybox_t(sp, MAX_IT).cpu().numpy()], [k3],
                  "box 3 lq anybox")
    for key, fn in 2 * (
            ("K1 box 3", lambda: mle_cuda.fit_t(sp, EPS, MAX_IT)),
            ("mle anybox box 3", lambda: mle_cuda.fit_anybox_t(sp, EPS,
                                                               MAX_IT)),
            ("K3 queue box 3", lambda: lq_cuda.fit_queue_t(sp, MAX_IT)),
            ("lq anybox box 3", lambda: lq_cuda.fit_anybox_t(sp, MAX_IT))):
        ms[key] = min(ms.get(key, float("inf")), _median_ms(fn))
    for key in ("K1 box 3", "K3 queue box 3"):
        box3[key] = {"ms": ms[key], "plain_ms": ms["plain " + key],
                     "bound_ms": bounds[key][0]}
    box3["mle anybox box 3 ms"] = ms["mle anybox box 3"]
    box3["lq anybox box 3 ms"] = ms["lq anybox box 3"]
    print("any-box bodies == K1/K3 queues at boxes 5-15 and == K5 at 7, 15, "
          f"the MLE and LM queues == their one-thread passes at "
          f"{QUEUE_BOXES}, {NO_STAGE_BOX} and {LQ_NO_STAGE_BOX} (LM), the "
          f"tiled cut == its direct kernel == plain at {CUT_BOXES} (u16, "
          "f32), K4 any-box == K4 at 3-15, bit for bit; box 3: K1, K2, K7, K5 "
          "(queue, phases, one pass), K3's queue, K6 and K5's LM queue == "
          "the one-thread passes bit for bit; vs plain:", json.dumps(box3))
    del sp, frames, hits
    t_b = time.perf_counter()

    # the kernels line at box 17 on N_SPOTS make_spots -------------------
    # the any-box MLE queue in turns with its one-thread pass
    box, spots = TIMED_BOX, timed_spots
    sp = torch.from_numpy(np.ascontiguousarray(
        spots.transpose(1, 2, 0))).to(dev)
    n = N_SPOTS
    for method in ("sigmaxy", "sigma"):
        tag = "" if method == "sigmaxy" else " sigma"
        key, one_key = "mle anybox" + tag, "mle anybox one pass" + tag
        coop = torch.zeros(1, dtype=torch.int32, device=dev)
        out = as_np(mle_cuda.fit_anybox_t(sp, EPS, MAX_IT, method,
                                          coop_steps=coop))
        _assert_equal(out, as_np(mle_cuda.fit_anybox_one_pass_t(
            sp, EPS, MAX_IT, method)), f"{key} vs the one-thread pass on "
            "make_spots")
        plain, ms["plain " + key] = _once_ms(
            lambda: mle._fit_core(sp, EPS, MAX_IT, method))
        ms["plain " + one_key] = ms["plain " + key]
        st = compare_fits(as_np(plain), out, MAX_IT, f"{key} on make_spots",
                          stuck_max=STUCK_XY_MAX_BOX17)
        errs[key] = errs[one_key] = st["xy_max_all"]
        one_t, queue_t = _alternate((
            lambda: mle_cuda.fit_anybox_one_pass_t(sp, EPS, MAX_IT, method),
            lambda: mle_cuda.fit_anybox_t(sp, EPS, MAX_IT, method)))
        ms[one_key] = statistics.median(one_t)
        ms[key] = statistics.median(queue_t)
        bounds[key] = bounds[one_key] = _fit_bound(
            n, float(out[3].sum()), mle_flops_per_spot_iter, 6 * 4 * 2 + 8,
            box * box * 4, box)
        print(f"{key} at box {box}: {int((out[3] == MAX_IT).sum())} fits at "
              f"max_it, {int(out[3].sum())} steps, {int(coop)} of them in "
              f"the cooperative tail; in turns one-thread pass / queue (ms): "
              f"{[round(t, 4) for t in one_t]} / "
              f"{[round(t, 4) for t in queue_t]}; queue config "
              f"{mle_cuda.anybox_queue_config(box)}, "
              f"{mle_cuda.anybox_queue_info(box, method)} ({smi})")
    # the any-box LM queue in turns with its one-thread pass
    th = lq_cuda.fit_anybox_t(sp, MAX_IT).cpu().numpy()
    _assert_equal([th], [lq_cuda.fit_anybox_one_pass_t(sp, MAX_IT).cpu(
    ).numpy()], "lq anybox vs the one-thread pass on make_spots")
    steps, _, reused = lq_iters(sp, MAX_IT)  # warms the plain LM, as above
    plain, ms["plain lq anybox"] = _once_ms(
        lambda: lq._lm_core(sp, MAX_IT, FTOL), warm=False)
    ms["plain lq anybox one pass"] = ms["plain lq anybox"]
    st = compare_lq_fits(plain.cpu().numpy(), th, spots.transpose(1, 2, 0),
                         "lq anybox on make_spots")
    errs["lq anybox"] = errs["lq anybox one pass"] = st["xy_p100"]
    one_t, queue_t = _alternate((
        lambda: lq_cuda.fit_anybox_one_pass_t(sp, MAX_IT),
        lambda: lq_cuda.fit_anybox_t(sp, MAX_IT)))
    ms["lq anybox one pass"] = statistics.median(one_t)
    ms["lq anybox"] = statistics.median(queue_t)
    bounds["lq anybox"] = bounds["lq anybox one pass"] = lq_fit_bound(
        n, float(steps.sum()), float(reused.sum()), box * box * 4, box)
    print(f"lq anybox at box {box}: {int((steps == MAX_IT).sum())} fits at "
          f"max_it, {int(steps.sum())} steps ({int(reused.sum())} after a "
          f"rejected step), the longest {int(steps.max())}; in turns "
          f"one-thread pass / queue (ms): {[round(t, 4) for t in one_t]} / "
          f"{[round(t, 4) for t in queue_t]}; queue config "
          f"{lq_cuda.anybox_queue_config(box)}, "
          f"{lq_cuda.anybox_queue_info(box)} ({smi})")
    del sp
    # the tiled cut in turns with its direct kernel, each through its
    # wrapper on the u16 chunk and the int64 hit rows, as the path calls
    # it (compaction's rows; the tiled cut reads them in place, the
    # direct kernel's wrapper stacks them into its int32 list): the
    # kernels line takes one median of single calls of each, as earlier
    # slices did; each kernel alone is its device time in a
    # torch.profiler trace, printed beside
    frames, hits = spots_chunk(spots, np.uint16)
    frames = torch.from_numpy(frames).to(dev)
    hits = [torch.from_numpy(h).to(dev) for h in hits]
    assert all(h.dtype == torch.int64 for h in hits)
    cut = winfit_cuda.cut_anybox_t(frames, *hits, box, 0.0, 1.0)
    plain_cut = winfit_cuda.photons_t(frames, *hits, box, 0.0, 1.0)
    if not torch.equal(cut, winfit_cuda.cut_anybox_direct_t(
            frames, *hits, box, 0.0, 1.0)):
        raise AssertionError("the tiled cut is not its direct kernel on "
                             "make_spots")
    errs["cut anybox"] = errs["cut anybox direct"] = float(
        (cut - plain_cut).abs().max())
    cuts = (lambda: winfit_cuda.cut_anybox_direct_t(frames, *hits, box, 0.0,
                                                    1.0),
            lambda: winfit_cuda.cut_anybox_t(frames, *hits, box, 0.0, 1.0))
    direct_t, tiled_t = _alternate(cuts)
    ms["cut anybox direct"] = _median_ms(cuts[0])
    ms["cut anybox"] = _median_ms(cuts[1])
    alone = [_kernel_device_ms(fn, name) for fn, name in
             zip(cuts, ("cut_any_direct_kernel", "cut_any_kernel"))]
    ms["plain cut anybox"] = ms["plain cut anybox direct"] = _median_ms(
        lambda: winfit_cuda.photons_t(frames, *hits, box, 0.0, 1.0))
    # u16 window and (f, y, x) int64 read, the f32 ROI written; 2 FLOPs a
    # pixel
    bounds["cut anybox"] = bounds["cut anybox direct"] = _bound(
        2 * n * box * box, n * (box * box * 6 + 24))
    print(f"cut anybox at box {box}: {n} hits of a {tuple(frames.shape)} "
          f"u16 chunk, int64 rows; == its direct kernel; a call through "
          f"the wrapper, median: direct {ms['cut anybox direct']:.4f}, "
          f"tiled {ms['cut anybox']:.4f}; in turns direct / tiled (ms): "
          f"{[round(t, 4) for t in direct_t]} / "
          f"{[round(t, 4) for t in tiled_t]}; the kernel alone (device "
          f"time, torch.profiler, a call of {PROFILED_CALLS}): direct "
          f"{_ms_or_not(alone[0])}, tiled {_ms_or_not(alone[1])}; config "
          f"{winfit_cuda.anybox_cut_config(box)} ({smi})")
    del frames, hits, cut, plain_cut
    # K4 at box 17 on the wide movie's first chunk, in turns with its
    # direct kernel
    tiles = as_np(identify_cuda.identify_tiles_anybox(first, WIDE_MIN_NG,
                                                      box))
    plain, ms["plain K4 anybox"] = _once_ms(
        lambda: identify.identify_tiles_plain(first, WIDE_MIN_NG, box))
    ms["plain K4 anybox direct"] = ms["plain K4 anybox"]
    plain = as_np(plain)
    compare_tiles(tiles, plain, f"K4 anybox at box {box}")
    errs["K4 anybox"] = errs["K4 anybox direct"] = float(
        np.abs(tiles[2] - plain[2]).max())
    direct_t, new_t = _alternate((
        lambda: identify_cuda.identify_tiles_anybox_direct(first, WIDE_MIN_NG,
                                                           box),
        lambda: identify_cuda.identify_tiles_anybox(first, WIDE_MIN_NG,
                                                    box)))
    ms["K4 anybox direct"] = statistics.median(direct_t)
    ms["K4 anybox"] = statistics.median(new_t)
    # what the function needs on this chunk: the separable maxima test's
    # K4_SEPARABLE_OPS compares at each pixel it tests, and the net
    # gradient (4 FLOPs a window position and 2) only at the local
    # maxima, counted from the kernel's tiles at no threshold; the u16
    # chunk read once, the tiles written once. (PR 23 charged box^2 - 1
    # compares a tested pixel: the direct test's count, printed beside.)
    h = box // 2
    tested = len(first) * (first.shape[1] - 2 * h - 1) * (
        first.shape[2] - 2 * h - 1)
    maxima = int(identify_cuda.identify_tiles_anybox(
        first, float("-inf"), box)[0].sum())
    ng_ops = maxima * (4 * (box * box - 1) + 2)
    k4_bytes = first.numel() * 2 + tiles[0].size * 9
    bounds["K4 anybox"] = bounds["K4 anybox direct"] = _bound(
        tested * K4_SEPARABLE_OPS + ng_ops, k4_bytes)
    direct_bound = _bound(tested * (box * box - 1) + ng_ops, k4_bytes)
    print(f"K4 anybox at box {box}: {tested} pixels tested, {maxima} local "
          f"maxima, {int(tiles[0].sum())} hits; == the direct kernel and "
          f"within compare_tiles of plain; in turns direct / new (ms): "
          f"{[round(t, 4) for t in direct_t]} / "
          f"{[round(t, 4) for t in new_t]}; tile "
          f"{identify_cuda.anybox_tile_shape(box)}; bound "
          f"{bounds['K4 anybox'][0]:.4f} ms ({bounds['K4 anybox'][1]}; the "
          f"direct test's count {direct_bound[0]:.4f} ms, "
          f"{direct_bound[1]}) ({smi})")
    del first
    torch.cuda.empty_cache()
    for key in ("mle anybox", "mle anybox sigma", "mle anybox one pass",
                "mle anybox one pass sigma", "lq anybox",
                "lq anybox one pass", "cut anybox", "cut anybox direct",
                "K4 anybox", "K4 anybox direct"):
        print(f"{key} at box {box}: {ms[key]:.4f} ms, plain "
              f"{ms['plain ' + key]:.3f} ms, bound {bounds[key][0]:.4f} ms "
              f"({bounds[key][1]}, {bounds[key][0] / ms[key]:.1%} of it), "
              f"max abs err vs plain {errs[key]} ({smi})")
    t_c = time.perf_counter()
    small = small_box_phase(bench, counted, smi)
    for have, more in zip((paths, ms, bounds, errs), small):
        have.update(more)
    print(f"phase 26: {time.perf_counter() - t0:.1f} s ((a) {t_a - t0:.1f}, "
          f"(b) {t_b - t_a:.1f}, timings {t_c - t_b:.1f}, (c) boxes 1 and 2 "
          f"{time.perf_counter() - t_c:.1f}) ({smi})")
    return paths, ms, bounds, errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from picasso_torch import (
        _build, aim, avgroi, gausslq, gaussmle, imageprocess, io, localize,
        postprocess, render, zfit,
    )
    from picasso_torch.ops import (
        cluster, fused, identify, identify_cuda, link, lq, lq_cuda, mle,
        mle_cuda, records, winfit_cuda,
    )
    from picasso_torch.ops._fit_common import FINISH
    from torch_data import (
        CALIB_3D, fiducial_tracks, free_positions, make_astig_movie,
        make_bench_movie, make_spots, make_wide_movie, spots_chunk,
        tiled_chunk, write_tiff,
    )
    from torch_parity import (
        compare_avg_photons, compare_fits, compare_fits_dense, compare_hits,
        compare_lq_fits, compare_tiles,
    )

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. environment -----------------------------------------------------
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print("card (nvidia-smi name, power.limit):")
    print(smi)

    # 2. build, with the slices' movie made alongside (nvcc runs in
    # processes of its own, numpy's sampler without the GIL) -------------
    def make_movie():
        t0 = time.perf_counter()
        movie = make_bench_movie(2048, 256, 1200, 0.5,
                                 np.random.default_rng(13), return_sites=True)
        return movie, time.perf_counter() - t0

    def make_astig():
        t0 = time.perf_counter()
        out = make_astig_movie(2048, 256, 1200, 0.5,
                               np.random.default_rng(17))
        return out, time.perf_counter() - t0

    def make_wide():
        t0 = time.perf_counter()
        out = make_wide_movie(2048, 256, 100, 0.5, np.random.default_rng(23))
        return out, time.perf_counter() - t0

    movie_pool = ThreadPoolExecutor(3)
    movie_job = movie_pool.submit(make_movie)
    astig_job = movie_pool.submit(make_astig)
    wide_job = movie_pool.submit(make_wide)
    timed_job = movie_pool.submit(make_spots, N_SPOTS, TIMED_BOX, seed=0)
    lib_path, build_s = _build.build()
    print(f"build: {build_s:.1f} s -> {lib_path}")
    for row in _ptxas_table((lib_path.parent / "build.log").read_text()):
        print("  ptxas:", row)
    _build.library()

    # 3. kernels against their plain versions ----------------------------
    spots = make_spots(N_SPOTS, BOX, seed=0)
    spots_t = torch.from_numpy(
        np.ascontiguousarray(spots.transpose(1, 2, 0))
    ).to(dev)
    spots_np = spots_t.cpu().numpy()
    as_np = lambda out: [a.cpu().numpy() for a in out]  # noqa: E731
    ms, stats, bounds = {}, {}, {}
    # method -> (plain, the one-thread pass, K2) on make_spots; the one
    # pass (mle_fit.cu FULL) is the fixed point every MLE kernel equals
    ref = {}
    for method in ("sigmaxy", "sigma"):
        tag = "" if method == "sigmaxy" else " sigma"
        plain = as_np(mle._fit_core(spots_t, EPS, MAX_IT, method))
        one = as_np(mle_cuda.fit_one_pass_t(spots_t, EPS, MAX_IT, method))
        torch.cuda.synchronize()
        stats["K1 one pass" + tag] = compare_fits(
            plain, one, MAX_IT, f"one pass{tag} vs plain")
        k2 = as_np(mle_cuda.fit_boundary_t(spots_t, EPS, MAX_IT, method))
        _assert_equal(k2, one, f"K2{tag} vs the one pass{tag}")
        stats["K2" + tag] = compare_fits(plain, k2, MAX_IT, f"K2{tag} vs plain")
        ref[method] = plain, one, k2
        print(f"one pass{tag} vs plain:",
              json.dumps(stats["K1 one pass" + tag]))
        print(f"K2{tag} vs plain:", json.dumps(stats["K2" + tag]),
              f"| K2{tag} == the one pass{tag} bit for bit")
        ms["plain_fit" + tag] = _median_ms(
            lambda: mle._fit_core(spots_t, EPS, MAX_IT, method))
        ms["K1 one pass" + tag] = _median_ms(
            lambda: mle_cuda.fit_one_pass_t(spots_t, EPS, MAX_IT, method))
        ms["K2" + tag] = _median_ms(
            lambda: mle_cuda.fit_boundary_t(spots_t, EPS, MAX_IT, method))
        bounds["K1" + tag] = bounds["K2" + tag] = _fit_bound(
            N_SPOTS, float(one[3].sum()), mle_flops_per_spot_iter, 56)
        bounds["K1 one pass" + tag] = bounds["K1" + tag]
        print(f"one pass{tag}/K2{tag} fit {N_SPOTS} spots (iterations mean "
              f"{one[3].mean():.2f}): one pass "
              f"{ms['K1 one pass' + tag]:.3f} ms, K2 "
              f"{ms['K2' + tag]:.3f} ms, plain {ms['plain_fit' + tag]:.3f} "
              f"ms, bound {bounds['K1' + tag][0]:.4f} ms "
              f"({bounds['K1' + tag][1]})")

    plain_lq = lq._lm_core(spots_t, MAX_IT, FTOL).cpu().numpy()
    k3 = lq_cuda.fit_t(spots_t, MAX_IT, FTOL).cpu().numpy()
    torch.cuda.synchronize()
    stats["K3"] = compare_lq_fits(plain_lq, k3, spots_np, "K3 vs plain")
    before = (lq_cuda.fit_boundary_t.launches, lq_cuda.fit_queue_t.launches)
    k6 = lq_cuda.fit_boundary_t(spots_t, MAX_IT, FTOL).cpu().numpy()
    if (lq_cuda.fit_boundary_t.launches - before[0],
            lq_cuda.fit_queue_t.launches - before[1]) != (1, 0):
        raise AssertionError("K6 is not one launch counted on itself")
    if not np.array_equal(k3, k6, equal_nan=True):
        raise AssertionError("K6 != K3 bit for bit")
    stats["K6"] = compare_lq_fits(plain_lq, k6, spots_np, "K6 vs plain")
    print("K3 vs plain:", json.dumps(stats["K3"]))
    print("K6 vs plain:", json.dumps(stats["K6"]), "| K6 == K3 bit for bit,"
          " 1 launch (roi_lq_queue)")
    lq_it, _, lq_reused = lq_iters(spots_t, MAX_IT)
    ms["plain_lq"] = _median_ms(lambda: lq._lm_core(spots_t, MAX_IT, FTOL))
    ms["K3"] = _median_ms(lambda: lq_cuda.fit_t(spots_t, MAX_IT, FTOL))
    ms["K6"] = _median_ms(lambda: lq_cuda.fit_boundary_t(spots_t, MAX_IT,
                                                          FTOL))
    bounds["K3"] = bounds["K6"] = lq_fit_bound(
        N_SPOTS, float(lq_it.sum()), float(lq_reused.sum()))
    print(f"K3/K6 fit {N_SPOTS} spots (LM iterations p50 "
          f"{np.percentile(lq_it, 50):.0f} p90 {np.percentile(lq_it, 90):.0f}"
          f" max {lq_it.max():.0f}): K3 {ms['K3']:.3f} ms, K6 "
          f"{ms['K6']:.3f} ms, plain {ms['plain_lq']:.3f} ms, bound "
          f"{bounds['K3'][0]:.4f} ms ({bounds['K3'][1]})")

    # K1: the work queue with the CRLB/LL in the kernel (roi_mle_fit.cu),
    # == the one pass bit for bit, one launch a fit; timed in turns with
    # the one pass (tests/torch_k1_queue_sweep.py times it against the
    # queue that writes a carry + the CRLB/LL pass)
    for method in ("sigmaxy", "sigma"):
        tag = "" if method == "sigmaxy" else " sigma"
        plain, one, _ = ref[method]
        coop = torch.zeros(1, dtype=torch.int32, device=dev)
        before = mle_cuda.fit_t.launches
        k1 = as_np(mle_cuda.fit_t(spots_t, EPS, MAX_IT, method,
                                  coop_steps=coop))
        if mle_cuda.fit_t.launches - before != 1:
            raise AssertionError("K1 took more than one launch")
        _assert_equal(k1, one, f"K1{tag} vs the one pass{tag}")
        stats["K1" + tag] = compare_fits(plain, k1, MAX_IT,
                                         f"K1{tag} vs plain")
        fns = (lambda: mle_cuda.fit_t(spots_t, EPS, MAX_IT, method),
               lambda: mle_cuda.fit_one_pass_t(spots_t, EPS, MAX_IT, method))
        turns = _turns([fns[i] for i in (0, 1, 1, 0)])
        ms["K1" + tag] = statistics.median(turns[0:4:3])
        k1_turns = {"K1": [turns[0], turns[3]],
                    "one pass": [turns[1], turns[2]]}
        b_ms = bounds["K1" + tag][0]
        print(f"K1{tag} (roi_mle_fit, 1 launch) == the one pass bit for bit;"
              f" fit {N_SPOTS} spots: {ms['K1' + tag]:.3f} ms "
              f"({b_ms / ms['K1' + tag]:.1%} of the bound {b_ms:.4f} ms "
              f"({bounds['K1' + tag][1]})), plain {ms['plain_fit' + tag]:.3f}"
              f" ms; cooperative steps {int(coop.item())}; ms in turns (A B B "
              f"A): {json.dumps(k1_turns)}; kernel "
              f"{mle_cuda.queue_info(BOX, method)}")
    coop = torch.zeros(1, dtype=torch.int32, device=dev)
    k3q = lq_cuda.fit_queue_t(spots_t, MAX_IT, FTOL,
                              coop_steps=coop).cpu().numpy()
    if not (np.array_equal(k3q, k3, equal_nan=True)
            and np.array_equal(k3q, k6, equal_nan=True)):
        raise AssertionError("K3 queue != K3, K6 bit for bit")
    stats["K3 queue"] = compare_lq_fits(plain_lq, k3q, spots_np,
                                        "K3 queue vs plain")
    ms["K3 queue"] = _median_ms(lambda: lq_cuda.fit_queue_t(spots_t, MAX_IT,
                                                            FTOL))
    bounds["K3 queue"] = bounds["K3"]
    # K6 is the queue's launch: the two in turns (K6 Q Q K6)
    fns = (lambda: lq_cuda.fit_boundary_t(spots_t, MAX_IT, FTOL),
           lambda: lq_cuda.fit_queue_t(spots_t, MAX_IT, FTOL))
    k6_turns = _turns([fns[i] for i in (0, 1, 1, 0)])
    print(f"K6 and the K3 queue in turns (K6 Q Q K6), ms: "
          f"{[round(t, 4) for t in k6_turns]}")
    print(f"K3 queue (roi_lq_queue) == K3 == K6 bit for bit; fit {N_SPOTS} "
          f"spots: {ms['K3 queue']:.3f} ms ({bounds['K3'][0] / ms['K3 queue']:.1%}"
          f" of the bound), K3 {ms['K3']:.3f} ms, plain {ms['plain_lq']:.3f} "
          f"ms; cooperative steps {int(coop.item())}; kernel "
          f"{lq_cuda.queue_info(BOX)}")
    # the ROI queues at the other boxes, == the one-thread kernels
    for box in (5, 9, 11, 13, 15):
        sp = torch.from_numpy(np.ascontiguousarray(
            make_spots(8192, box, seed=box).transpose(1, 2, 0))).to(dev)
        for method in ("sigmaxy", "sigma"):
            one = as_np(mle_cuda.fit_one_pass_t(sp, EPS, MAX_IT, method))
            for fit in (mle_cuda.fit_t, mle_cuda.fit_boundary_t):
                _assert_equal(as_np(fit(sp, EPS, MAX_IT, method)), one,
                              f"box {box} {fit.__name__} {method} vs the one "
                              "pass")
        q = lq_cuda.fit_queue_t(sp, MAX_IT, FTOL).cpu().numpy()
        for other in (lq_cuda.fit_t, lq_cuda.fit_boundary_t):
            if not np.array_equal(q, other(sp, MAX_IT, FTOL).cpu().numpy(),
                                  equal_nan=True):
                raise AssertionError(f"box {box} K3 queue != {other.__name__}")
    print("boxes 5, 9, 11, 13, 15 (8192 make_spots each): K1, K2 == the one "
          "pass (sigmaxy, sigma), K3 queue == K3 == K6, bit for bit")
    for box in (5, 7, 9, 11, 13, 15):
        rows = {f"K1 {m}": mle_cuda.queue_info(box, m)
                for m in ("sigmaxy", "sigma")}
        rows["lq"] = lq_cuda.queue_info(box)
        print(f"  ROI queues box {box} (registers, local bytes, blocks a SM):",
              json.dumps({k: (v["registers"], v["local_bytes"],
                              v["blocks_per_sm"]) for k, v in rows.items()}))
        if box == BOX and any(v["local_bytes"] for v in rows.values()):
            raise AssertionError(f"a ROI queue spills at box {BOX}: {rows}")
    for row in _ptxas_table((lib_path.parent / "build.log").read_text()):
        if "RoiBatch" in row:
            print("  ROI queue ptxas:", row)

    # K5 on the same spots laid out as u16 and f32 frame chunks: with
    # baseline 0 and factor 1 its photons are the spots themselves, so it
    # equals the one pass, K2 (phases) and K3 bit for bit
    def upload_chunk(dtype):
        frames, hits = spots_chunk(spots, dtype)
        return (torch.from_numpy(frames).to(dev),
                [torch.from_numpy(h).to(dev) for h in hits])

    for dt in (np.uint16, np.float32):
        win, hits = upload_chunk(dt)
        name = np.dtype(dt).name
        for method in ("sigmaxy", "sigma"):
            tag = "" if method == "sigmaxy" else " sigma"
            kw = dict(box=BOX, eps=EPS, max_it=MAX_IT, method=method)
            plain, k1, k2 = ref[method]
            _assert_equal(as_np(winfit_cuda.fit_mle_t(win, *hits, 0.0, 1.0,
                                                      **kw)),
                          k1, f"K5{tag} one pass ({name}) vs the one pass")
            k5 = as_np(winfit_cuda.fit_mle_boundary_t(win, *hits, 0.0, 1.0,
                                                      **kw))
            _assert_equal(k5, k2, f"K5{tag} phases ({name}) vs K2{tag}")
            stats["K5" + tag] = compare_fits(plain, k5, MAX_IT,
                                             f"K5{tag} ({name}) vs plain")
            kq = as_np(winfit_cuda.fit_mle_queue_t(win, *hits, 0.0, 1.0,
                                                   **kw))
            _assert_equal(kq, k1, f"K5 queue{tag} ({name}) vs the one pass")
            _assert_equal(kq, k2, f"K5 queue{tag} ({name}) vs K2{tag}")
            stats["K5 queue" + tag] = compare_fits(
                plain, kq, MAX_IT, f"K5 queue{tag} ({name}) vs plain")
        coop = torch.zeros(1, dtype=torch.int32, device=dev)
        k5lqq = winfit_cuda.fit_lq_queue_t(
            win, *hits, 0.0, 1.0, box=BOX, max_it=MAX_IT, ftol=FTOL,
            coop_steps=coop).cpu().numpy()
        if not np.array_equal(k5lqq, k3, equal_nan=True):
            raise AssertionError(f"K5 lq queue ({name}) != K3 bit for bit")
        stats["K5 lq queue"] = compare_lq_fits(
            plain_lq, k5lqq, spots_np, f"K5 lq queue ({name}) vs plain")
        coop_make_spots = int(coop.item())
        print(f"K5 on make_spots as a {name} chunk {tuple(win.shape)}: "
              "queue, one pass and phases == the one pass and K2 (sigmaxy, "
              "sigma), "
              "LM queue == K3, bit for bit; LM queue cooperative steps "
              f"{coop_make_spots}")
    for key in ("K5 queue", "K5 queue sigma", "K5", "K5 sigma",
                "K5 lq queue"):
        print(f"{key} vs plain:", json.dumps(stats[key]))
    win, hits = upload_chunk(np.uint16)
    for method in ("sigmaxy", "sigma"):
        tag = "" if method == "sigmaxy" else " sigma"
        kw = dict(box=BOX, eps=EPS, max_it=MAX_IT, method=method)
        ms["K5" + tag] = _median_ms(
            lambda: winfit_cuda.fit_mle_boundary_t(win, *hits, 0.0, 1.0, **kw))
        ms["K5 one pass" + tag] = _median_ms(
            lambda: winfit_cuda.fit_mle_t(win, *hits, 0.0, 1.0, **kw))
        ms["plain K5" + tag] = _median_ms(lambda: mle._fit_core(
            winfit_cuda.photons_t(win, *hits, BOX, 0.0, 1.0), EPS, MAX_IT,
            method))
        bounds["K5" + tag] = _fit_bound(
            N_SPOTS, float(ref[method][1][3].sum()), mle_flops_per_spot_iter,
            56, K5_IN_BYTES)
        bounds["K5 one pass" + tag] = bounds["K5" + tag]
        # the queue: the same work as K5, so the same bound
        ms["K5 queue" + tag] = _median_ms(
            lambda: winfit_cuda.fit_mle_queue_t(win, *hits, 0.0, 1.0, **kw))
        bounds["K5 queue" + tag] = bounds["K5" + tag]
        h32 = torch.stack(hits).to(torch.int32).contiguous()
        carry = winfit_cuda._launch_queue(_build.library(), win, h32, 0.0,
                                          1.0, BOX, EPS, MAX_IT, method)
        ms["K5 queue pass" + tag] = _median_ms(
            lambda: winfit_cuda._launch_queue(_build.library(), win, h32, 0.0,
                                              1.0, BOX, EPS, MAX_IT, method))
        ms["K5 finish pass" + tag] = _median_ms(
            lambda: winfit_cuda._launch_mle(FINISH, win, h32, 0.0, 1.0, BOX,
                                            EPS, 0, method, carry))
        info = {dt: winfit_cuda.queue_info(dt, BOX, method)
                for dt in (torch.uint16, torch.float32)}
        b_ms = bounds["K5" + tag][0]
        print(f"K5{tag} fit {N_SPOTS} spots from the u16 chunk: queue "
              f"{ms['K5 queue' + tag]:.3f} ms (queue launch "
              f"{ms['K5 queue pass' + tag]:.3f}, CRLB/LL pass "
              f"{ms['K5 finish pass' + tag]:.3f}; "
              f"{b_ms / ms['K5 queue' + tag]:.1%} of the bound), phases {ms['K5' + tag]:.3f} ms, one pass "
              f"{ms['K5 one pass' + tag]:.3f} ms, plain (cut + photons + "
              f"plain fit) {ms['plain K5' + tag]:.3f} ms, bound "
              f"{b_ms:.4f} ms ({bounds['K5' + tag][1]}); queue kernel "
              f"(u16, f32): {info[torch.uint16]}, {info[torch.float32]}")
    ms["plain K5 lq"] = _median_ms(lambda: lq._lm_core(
        winfit_cuda.photons_t(win, *hits, BOX, 0.0, 1.0), MAX_IT, FTOL))
    bounds["K5 lq queue"] = lq_fit_bound(
        N_SPOTS, float(lq_it.sum()), float(lq_reused.sum()), K5_IN_BYTES)
    # the bound of earlier PERF.md rows: a full step for every step
    full_step = lq_fit_bound(N_SPOTS, float(lq_it.sum()), 0.0, K5_IN_BYTES)
    ms["K5 lq queue"] = _median_ms(lambda: winfit_cuda.fit_lq_queue_t(
        win, *hits, 0.0, 1.0, box=BOX, max_it=MAX_IT, ftol=FTOL))
    b_ms = bounds["K5 lq queue"][0]
    print(f"K5 lq fit {N_SPOTS} spots from the u16 chunk: queue "
          f"{ms['K5 lq queue']:.3f} ms, plain {ms['plain K5 lq']:.3f} ms, "
          f"bound {b_ms:.4f} ms ({bounds['K5 lq queue'][1]}; "
          f"{b_ms / ms['K5 lq queue']:.1%} of it; full-step bound "
          f"{full_step[0]:.4f} ms, {lq_reused.sum() / lq_it.sum():.1%} of "
          "the steps reuse the normal equations); LM queue kernel "
          f"(u16, f32): {winfit_cuda.lq_queue_info(torch.uint16, BOX)}, "
          f"{winfit_cuda.lq_queue_info(torch.float32, BOX)}")
    for row in _ptxas_table((lib_path.parent / "build.log").read_text()):
        if row.startswith("lq_queue") and "Chunk" in row:
            print("  K5 lq ptxas:", row)
    del win, hits

    # K7: the sigmaxy fit in rounds of ROUND_IT on the TPU; on the card one
    # launch of K1's work queue, whose slots take the next spot as their
    # own converges (no rounds); its plain version keeps the rounds
    before = mle_cuda.fit_multiround_t.launches
    k7 = as_np(mle_cuda.fit_multiround_t(spots_t, EPS, MAX_IT, ROUND_IT))
    k7_calls = mle_cuda.fit_multiround_t.launches - before
    _assert_equal(k7, ref["sigmaxy"][1], "K7 vs the one pass")
    _assert_equal(as_np(_plain_multiround(spots_t, MAX_IT)),
                  ref["sigmaxy"][0], "plain K7 vs the plain fit")
    stats["K7"] = compare_fits(ref["sigmaxy"][0], k7, MAX_IT, "K7 vs plain")
    if k7_calls != 1:
        raise AssertionError(f"K7 took {k7_calls} launches, not 1")
    # in turns with K1 (the same kernel) on the same spots: K7 K1 K1 K7
    k7_turns = _turns([
        lambda: mle_cuda.fit_multiround_t(spots_t, EPS, MAX_IT, ROUND_IT),
        lambda: mle_cuda.fit_t(spots_t, EPS, MAX_IT)][i] for i in (0, 1, 1, 0))
    ms["K7"] = statistics.median(k7_turns[0:4:3])
    ms["plain K7"] = _median_ms(lambda: _plain_multiround(spots_t, MAX_IT))
    bounds["K7"] = bounds["K1"]
    print(f"K7 (rounds of {ROUND_IT} on the TPU; {k7_calls} launch a fit "
          f"here) == K1 == the one pass bit for bit, plain K7 == plain fit; "
          f"fit {N_SPOTS} spots: K7 {ms['K7']:.3f} ms "
          f"({bounds['K7'][0] / ms['K7']:.1%} of the bound; in turns K7 K1 "
          f"K1 K7: {json.dumps([round(x, 4) for x in k7_turns])}),"
          f" plain {ms['plain K7']:.3f} ms, bound {bounds['K7'][0]:.4f} ms "
          f"({bounds['K7'][1]}); K7 vs plain:", json.dumps(stats["K7"]))

    (movie, bench_sites), movie_s = movie_job.result()
    print(f"movie {movie.shape} {movie.dtype}: {movie_s:.1f} s to generate "
          "(alongside the build)")
    # K4 on chunk 0 and on a (32, 2048, 2048) chunk tiled 8x8 from its
    # frames; one call at a time (as every kernel here), and per call in
    # runs of K4_CALLS back-to-back calls
    chunk = identify.upload_frames(movie[:CHUNK], dev)
    k4_inputs = {"chunk 0": chunk, "tiled": tiled_chunk(chunk)}
    k4_err, k4_hits = 0.0, {}
    for what, frames in k4_inputs.items():
        tiles_p = [a.cpu().numpy() for a in
                   identify.identify_tiles_plain(frames, MIN_NG, BOX)]
        tiles_k = [a.cpu().numpy() for a in
                   identify_cuda.identify_tiles(frames, MIN_NG, BOX)]
        compare_tiles(tiles_k, tiles_p, f"K4 on {what}")
        k4_err = max(k4_err, float(np.abs(tiles_k[2] - tiles_p[2]).max()))
        k4_hits[what] = int(tiles_k[0].sum())
        key = "K4" if what == "chunk 0" else "K4 tiled"
        ms["plain " + key] = _median_ms(
            lambda: identify.identify_tiles_plain(frames, MIN_NG, BOX))
        ms[key] = _median_ms(
            lambda: identify_cuda.identify_tiles(frames, MIN_NG, BOX))
        ms[key + " runs"] = _median_ms(
            lambda: identify_cuda.identify_tiles(frames, MIN_NG, BOX),
            calls=K4_CALLS)
        # per pixel: box^2-1 compares, 2 (box^2-1) FMAs of the net
        # gradient, 2 gradient differences; u16 in, (mask u8, loc i32, ng
        # f32) per tile
        px = frames.numel()
        bounds[key] = _bound(px * ((BOX * BOX - 1) * 5 + 2),
                             px * 2 + tiles_k[0].size * 9)
    del k4_inputs, frames
    print(f"K4 vs plain (compare_tiles): hit tiles {k4_hits} equal, ng max "
          f"abs err {k4_err}")
    for what, key in (("(256, 256, 256)", "K4"),
                      ("(32, 2048, 2048)", "K4 tiled")):
        print(f"K4 identify {what} u16: kernel {ms[key]:.4f} ms, plain "
              f"{ms['plain ' + key]:.3f} ms, bound {bounds[key][0]:.4f} ms "
              f"({bounds[key][1]}, {bounds[key][0] / ms[key]:.1%} of it)")
        print(f"  K4 {what} per call in runs of {K4_CALLS} calls: "
              f"{ms[key + ' runs']:.4f} ms ({bounds[key][0] / ms[key + ' runs']:.1%}"
              " of the bound)")
    for row in _ptxas_table((lib_path.parent / "build.log").read_text()):
        if row.startswith(f"identify_kernel<Li{BOX}E"):
            print("  K4 ptxas:", row)
    for dt in (torch.uint16, torch.float32):
        print(f"  K4 box {BOX} {dt}: {identify_cuda.kernel_info(dt, BOX)}")

    camera = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    params = {"Min. Net Gradient": MIN_NG, "Box Size": BOX}
    counters = {"K1": mle_cuda.fit_t, "K1 one pass": mle_cuda.fit_one_pass_t,
                "K2": mle_cuda.fit_boundary_t,
                "K3": lq_cuda.fit_t, "K6": lq_cuda.fit_boundary_t,
                "K3 queue": lq_cuda.fit_queue_t,
                "K4": identify_cuda.identify_tiles,
                "K5 mle one pass": winfit_cuda.fit_mle_t,
                "K5 mle phases": winfit_cuda.fit_mle_boundary_t,
                "K5 mle queue": winfit_cuda.fit_mle_queue_t,
                "K5 lq queue": winfit_cuda.fit_lq_queue_t,
                "K7": mle_cuda.fit_multiround_t, "link walk": link.walk,
                "cluster sweep": cluster.sweep,
                "K4 anybox": identify_cuda.identify_tiles_anybox,
                "K4 anybox direct": identify_cuda.identify_tiles_anybox_direct,
                "mle anybox": mle_cuda.fit_anybox_t,
                "mle anybox one pass": mle_cuda.fit_anybox_one_pass_t,
                "lq anybox": lq_cuda.fit_anybox_t,
                "lq anybox one pass": lq_cuda.fit_anybox_one_pass_t,
                "cut anybox": winfit_cuda.cut_anybox_t,
                "cut anybox direct": winfit_cuda.cut_anybox_direct_t,
                "apply_drift records": records.apply_drift_records}

    n_chunks = -(-len(movie) // CHUNK)

    def check_route(what: str, launches: dict, fit: str | None,
                    per_chunk: int = 1, fit_launches: int | None = None
                    ) -> None:
        """K4 launched once a chunk and the fit ``fit`` ``per_chunk``
        times a chunk (or ``fit_launches`` times), no other fit."""
        idle = [k for k, v in launches.items() if v and k not in ("K4", fit)]
        want = per_chunk * n_chunks if fit_launches is None else fit_launches
        if (launches["K4"] != n_chunks or idle
                or (fit is not None and launches[fit] != want)):
            raise AssertionError(f"{what} did not run through K4 and "
                                 f"{fit} only: {launches}")

    def counted(fn):
        """``fn()`` on the card with every count set to 0 just before it;
        returns (result, wall seconds, launches)."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, {k: c.launches for k, c in counters.items()}

    def run_slice(fitting_method: str, src=None, **kw):
        """One localize call on the card (on ``src``, the in-RAM movie by
        default) with every count set to 0 just before it; returns (locs,
        wall seconds, launches)."""
        what = " ".join([fitting_method, *map(str, kw.values())])
        if src is not None:
            what += " (TIFF series)"
        locs, wall, launches = counted(lambda: localize.localize(
            movie if src is None else src, dict(camera), params,
            fitting_method=fitting_method, device="cuda", **kw))
        print(f"{what} slice: {len(locs)} locs from {len(movie)} "
              f"frames in {wall:.3f} s = {len(movie) / wall:.1f} frames/s, "
              f"{len(locs) / wall:.0f} spots/s; launches {launches}")
        # diverged LQ fits may leave the box; >= 99% stay finite
        for name in ("x", "y", "photons", "sx", "sy", "bg"):
            if np.isfinite(locs[name]).mean() < 0.99:
                raise AssertionError(f"{what} slice: non-finite {name}")
        return locs, wall, launches

    # 4. the MLE slice ---------------------------------------------------
    locs, wall, launches_mle = run_slice("gaussmle")
    # the main path fits through K5's work queue, 2 launches a chunk
    # (ops/fused.py); the gather route's K1/K2 and K5's phases and single
    # pass are not on it
    check_route("MLE slice", launches_mle, "K5 mle queue", 2)
    if len(locs) == 0:
        raise AssertionError("MLE slice found no locs")
    for name in ("x", "y", "photons", "sx", "sy", "bg"):
        if not np.isfinite(locs[name]).all():
            raise AssertionError(f"slice: non-finite {name}")

    # the slice's wall split: the chunk loop, then the locs table
    t0 = time.perf_counter()
    mle_ids, mle_fits = fused.localize_fused(movie, MIN_NG, BOX, camera,
                                             device="cuda")
    t1 = time.perf_counter()
    gaussmle.locs_from_fits(mle_ids, *mle_fits, BOX)
    t2 = time.perf_counter()
    print(f"MLE slice split: localize_fused {t1 - t0:.3f} s, locs_from_fits "
          f"{t2 - t1:.3f} s")

    # the first chunk again: kernels (same calls as the slice) and plain
    ker = [a.cpu().numpy() for a in fused.identify_cut_fit(
        chunk, MIN_NG, 0.0, 1.0, box=BOX, eps=EPS, max_it=MAX_IT)]
    first = locs[locs["frame"] < CHUNK]
    if len(first) != ker[0].shape[0] or not np.array_equal(
        first["x"], (ker[4][0] + ker[2] - BOX // 2).astype(np.float32)
    ):
        raise AssertionError("slice's first chunk differs from a re-run")
    f, y, x, ng = identify.compact(
        *identify.identify_tiles_plain(chunk, MIN_NG, BOX), BOX
    )
    dense = winfit_cuda.photons_t(chunk, f, y, x, BOX, 0.0, 1.0)
    pl = [a.cpu().numpy() for a in
          (f, y, x, ng, *mle._fit_core(dense, EPS, MAX_IT))]
    pairs = compare_hits(pl[:4], ker[:4], MIN_NG, "slice chunk 0 hits")
    pi, ki = pairs[:, 0], pairs[:, 1]
    chunk_stats = compare_fits(
        [pl[4][:, pi], pl[5][:, pi], pl[6][pi], pl[7][pi]],
        [ker[4][:, ki], ker[5][:, ki], ker[6][ki], ker[7][ki]],
        MAX_IT, "slice chunk 0 fits",
    )
    print(f"MLE slice chunk 0 vs plain: {len(pl[0])} plain hits, "
          f"{len(ker[0])} kernel hits, {len(pairs)} matched;",
          json.dumps(chunk_stats))

    # K5 against the gather route on the chunk's real hits, where some
    # spots run to max_it: K5's queue and phases from the u16 and the f32
    # chunk and K5 in one pass equal cut + photons + K2 (== K1) bit for
    # bit, at the slice's camera constants and at baseline 1.5, factor
    # 0.8; then the routes in turns: (A) cut + photons + K2, (B) K5 in
    # phases, (D) K5's queue, (C) K5 in one pass; then the queue without
    # the spots that run to max_it, and on those alone
    hits_k = identify.compact(
        *identify_cuda.identify_tiles(chunk, MIN_NG, BOX), BOX)[:3]
    chunk32 = chunk.to(torch.float32)
    rois = {}
    for method in ("sigmaxy", "sigma"):
        kw = dict(box=BOX, eps=EPS, max_it=MAX_IT, method=method)
        for b, c in ((0.0, 1.0), (1.5, 0.8)):
            what = f"chunk 0 {method} (baseline {b}, factor {c})"
            r = winfit_cuda.photons_t(chunk, *hits_k, BOX, b, c)
            k2g = as_np(mle_cuda.fit_boundary_t(r, EPS, MAX_IT, method))
            for fit in (mle_cuda.fit_t, mle_cuda.fit_one_pass_t):
                _assert_equal(as_np(fit(r, EPS, MAX_IT, method)), k2g,
                              f"{what}: {fit.__name__} vs K2")
            _assert_equal(as_np(winfit_cuda.fit_mle_t(chunk, *hits_k, b, c,
                                                      **kw)),
                          k2g, f"{what}: K5 one pass vs cut + photons + K2")
            for src in (chunk, chunk32):
                _assert_equal(as_np(winfit_cuda.fit_mle_boundary_t(
                    src, *hits_k, b, c, **kw)), k2g,
                    f"{what}: K5 phases ({src.dtype}) vs cut + photons + K2")
                _assert_equal(as_np(winfit_cuda.fit_mle_queue_t(
                    src, *hits_k, b, c, **kw)), k2g,
                    f"{what}: K5 queue ({src.dtype}) vs cut + photons + K2")
            if b == 0.0:
                rois[method], it = r, k2g[3]
        routes = (
            lambda: mle_cuda.fit_boundary_t(winfit_cuda.photons_t(
                chunk, *hits_k, BOX, 0.0, 1.0), EPS, MAX_IT, method),
            lambda: winfit_cuda.fit_mle_boundary_t(chunk, *hits_k, 0.0, 1.0,
                                                   **kw),
            lambda: winfit_cuda.fit_mle_t(chunk, *hits_k, 0.0, 1.0, **kw),
            lambda: winfit_cuda.fit_mle_queue_t(chunk, *hits_k, 0.0, 1.0,
                                                **kw),
        )
        route_ms = _turns((routes[i] for i in (0, 1, 3, 2, 2, 3, 1, 0)), 9)
        at_max = torch.from_numpy(it == MAX_IT).to(dev)
        parts = ([h[~at_max] for h in hits_k], [h[at_max] for h in hits_k])
        tail_ms = _turns(
            (lambda h=h: winfit_cuda.fit_mle_queue_t(chunk, *h, 0.0, 1.0,
                                                     **kw))
            for h in (*parts, *parts[::-1]))
        print(f"chunk 0 {method} ({len(it)} hits, iterations p50 "
              f"{np.percentile(it, 50):.0f} p90 {np.percentile(it, 90):.0f}, "
              f"{np.mean(it == MAX_IT):.4f} at max_it, mean {it.mean():.2f})"
              f": K5 (queue, phases from u16 and f32; one pass) == cut + "
              f"photons + K2 == K1 == the one pass bit for bit; route ms in "
              f"turn A "
              f"gather+K2, B K5 phases, D K5 queue, C K5 one pass, C, D, B, "
              f"A: {[round(t, 4) for t in route_ms]}; queue without the "
              f"{int(at_max.sum())} max_it spots, on them alone, alone, "
              f"without: {[round(t, 4) for t in tail_ms]}")

    # K7 on the chunk's ROIs: == K1 == the one pass bit for bit, timed in
    # turns with K2
    k7d = as_np(mle_cuda.fit_multiround_t(rois["sigmaxy"], EPS, MAX_IT,
                                          ROUND_IT))
    for fit in (mle_cuda.fit_t, mle_cuda.fit_one_pass_t):
        _assert_equal(k7d, as_np(fit(rois["sigmaxy"], EPS, MAX_IT)),
                      f"chunk 0: K7 vs {fit.__name__}")
    routes = (
        lambda: mle_cuda.fit_boundary_t(rois["sigmaxy"], EPS, MAX_IT),
        lambda: mle_cuda.fit_multiround_t(rois["sigmaxy"], EPS, MAX_IT,
                                          ROUND_IT),
    )
    k7_ms = _turns(routes[i] for i in (0, 1, 1, 0))
    print(f"chunk 0 ROIs: K7 (1 launch) == K1 == the one pass bit for bit; "
          f"ms in turn K2, K7, K7, K2: {[round(t, 4) for t in k7_ms]}")

    # the stages of one chunk on the card, each alone
    tiles = identify_cuda.identify_tiles(chunk, MIN_NG, BOX)
    stages = {
        "upload": lambda: identify.upload_frames(movie[:CHUNK], dev),
        "K4 identify": lambda: identify_cuda.identify_tiles(
            chunk, MIN_NG, BOX),
        "compact": lambda: identify.compact(*tiles, BOX),
        "K5 fit (queue)": lambda: winfit_cuda.fit_mle_queue_t(
            chunk, *hits_k, 0.0, 1.0, box=BOX, eps=EPS, max_it=MAX_IT),
        "K5 fit (phases)": lambda: winfit_cuda.fit_mle_boundary_t(
            chunk, *hits_k, 0.0, 1.0, box=BOX, eps=EPS, max_it=MAX_IT),
        "packed chunk + readback": lambda: fused.identify_cut_fit_packed(
            chunk, MIN_NG, 0.0, 1.0, box=BOX, eps=EPS, max_it=MAX_IT,
        ).cpu(),
    }
    print("MLE chunk stages (ms, median of 5):", json.dumps(
        {k: round(_median_ms(fn), 4) for k, fn in stages.items()}))

    # 5. the MLE slice with mle_method="sigma" ---------------------------
    locs_sig, _, launches_sig = run_slice("gaussmle", mle_method="sigma")
    # the sigma route: K4, then K5 on the route of ops/fused.py
    # MLE_FITS["sigma"]: the work queue (2 launches a chunk) or K5's phases
    # (3), whichever had the lower median in this phase's turns
    sig_queue = fused.MLE_FITS["sigma"] is winfit_cuda.fit_mle_queue_t
    sig_key = "K5 mle queue" if sig_queue else "K5 mle phases"
    check_route("sigma slice", launches_sig, sig_key, 2 if sig_queue else 3)
    if not np.array_equal(locs_sig["sx"], locs_sig["sy"]):
        raise AssertionError("sigma slice: sx != sy, not the sigma fit")
    ker_s = [a.cpu().numpy() for a in fused.identify_cut_fit(
        chunk, MIN_NG, 0.0, 1.0, box=BOX, eps=EPS, max_it=MAX_IT,
        method="sigma")]
    first = locs_sig[locs_sig["frame"] < CHUNK]
    if len(first) != ker_s[0].shape[0] or not np.array_equal(
        first["x"], (ker_s[4][0] + ker_s[2] - BOX // 2).astype(np.float32)
    ):
        raise AssertionError("sigma slice's first chunk differs from a re-run")
    pls = [a.cpu().numpy() for a in mle._fit_core(dense, EPS, MAX_IT, "sigma")]
    pairs = compare_hits(pl[:4], ker_s[:4], MIN_NG, "sigma slice chunk 0 hits")
    pi, ki = pairs[:, 0], pairs[:, 1]
    sig_chunk_stats = compare_fits(
        [pls[0][:, pi], pls[1][:, pi], pls[2][pi], pls[3][pi]],
        [ker_s[4][:, ki], ker_s[5][:, ki], ker_s[6][ki], ker_s[7][ki]],
        MAX_IT, "sigma slice chunk 0 fits",
    )
    print(f"sigma slice chunk 0 vs plain: {len(pairs)} matched hits;",
          json.dumps(sig_chunk_stats))
    # the sigma route in ROUTE_TURNS alternating turns on chunk 0's hits:
    # K5's phases against its work queue (the rule behind MLE_FITS)
    sig_kw = dict(box=BOX, eps=EPS, max_it=MAX_IT, method="sigma")
    turns = _alternate((
        lambda: winfit_cuda.fit_mle_boundary_t(chunk, *hits_k, 0.0, 1.0,
                                               **sig_kw),
        lambda: winfit_cuda.fit_mle_queue_t(chunk, *hits_k, 0.0, 1.0,
                                            **sig_kw)))
    sig_route = {"turns_ms": {"K5 phases": [round(t, 4) for t in turns[0]],
                              "K5 queue": [round(t, 4) for t in turns[1]]},
                 "route": ("queue" if statistics.median(turns[1])
                           < statistics.median(turns[0]) else "phases"),
                 "route_set": "queue" if sig_queue else "phases",
                 "launches": launches_sig[sig_key]}
    print(f"sigma route on chunk 0 ({len(hits_k[0])} hits, {ROUTE_TURNS} "
          "alternating turns):", json.dumps(sig_route))
    if sig_route["route"] != sig_route["route_set"]:
        print(f"note: K5 sigma: this run's turns favour the "
              f"{sig_route['route']}, MLE_FITS takes the "
              f"{sig_route['route_set']}")

    # 6. the LQ slice ----------------------------------------------------
    locs_lq, wall_lq, launches_lq = run_slice("gausslq")
    # the LQ route is K5's work queue (ops/fused.py); K3 and K6 are off it
    check_route("LQ slice", launches_lq, "K5 lq queue")
    if not len(locs_lq):
        raise AssertionError("LQ slice found no locs")
    t0 = time.perf_counter()
    ids, fits = fused.localize_fused(movie, MIN_NG, BOX, camera,
                                     fitting_method="gausslq", device="cuda")
    t1 = time.perf_counter()
    gausslq.locs_from_fits(ids, fits[0], BOX, False)
    t2 = time.perf_counter()
    print(f"LQ slice split: localize_fused {t1 - t0:.3f} s, locs_from_fits "
          f"{t2 - t1:.3f} s")

    ker = [a.cpu().numpy() for a in fused.identify_cut_fit(
        chunk, MIN_NG, 0.0, 1.0, box=BOX, eps=EPS, max_it=MAX_IT,
        method="lq")]
    first = locs_lq[locs_lq["frame"] < CHUNK]
    if len(first) != ker[0].shape[0] or not np.array_equal(
        first["x"], (ker[4][0] + ker[2]).astype(np.float32)
    ):
        raise AssertionError("LQ slice's first chunk differs from a re-run")
    plain_chunk = lq._lm_core(dense, MAX_IT, FTOL).cpu().numpy()
    pairs = compare_hits(pl[:4], ker[:4], MIN_NG, "LQ slice chunk 0 hits")
    pi, ki = pairs[:, 0], pairs[:, 1]
    dense_np = dense.cpu().numpy()
    lq_chunk_stats = compare_lq_fits(plain_chunk[:, pi], ker[4][:, ki],
                                     dense_np[:, :, pi], "LQ slice chunk 0")
    print(f"LQ slice chunk 0 vs plain: {len(pairs)} matched hits;",
          json.dumps(lq_chunk_stats))

    # K5 against the gather route (cut + photons + K3) on the chunk's
    # hits, from u16 and f32 frames, at two camera constants; the plain
    # version's steps there; then the routes in turns, the tail split,
    # and K3 against K6 on the chunk's ROIs
    lq_kw = dict(box=BOX, max_it=MAX_IT, ftol=FTOL)
    coop_chunk = torch.zeros(1, dtype=torch.int32, device=dev)
    for b, c in ((0.0, 1.0), (1.5, 0.8)):
        k3g = lq_cuda.fit_t(winfit_cuda.photons_t(chunk, *hits_k, BOX, b, c),
                            MAX_IT, FTOL).cpu().numpy()
        for src in (chunk, chunk32):
            count = coop_chunk if (b, src.dtype) == (0.0, torch.uint16) \
                else None
            k5g = winfit_cuda.fit_lq_queue_t(src, *hits_k, b, c,
                                             coop_steps=count, **lq_kw)
            if not np.array_equal(k5g.cpu().numpy(), k3g, equal_nan=True):
                raise AssertionError(
                    f"chunk 0 lq (baseline {b}, factor {c}): K5 queue "
                    f"({src.dtype}) != cut + photons + K3 bit for bit")
    if coop_chunk.item() <= 0:
        raise AssertionError("chunk 0 lq: the queue took no cooperative "
                             "step")
    r = rois["sigmaxy"]
    k6d = lq_cuda.fit_boundary_t(r, MAX_IT, FTOL).cpu().numpy()
    if not np.array_equal(lq_cuda.fit_t(r, MAX_IT, FTOL).cpu().numpy(), k6d,
                          equal_nan=True):
        raise AssertionError("chunk 0: K6 != K3 bit for bit")
    it, rejected, reused = lq_iters(r, MAX_IT)
    print(f"chunk 0 lq ({r.shape[-1]} hits): K5 queue (u16, f32) == cut "
          f"+ photons + K3 bit for bit, K6 == K3 bit for bit; "
          f"queue cooperative steps {int(coop_chunk.item())}; plain LM "
          f"steps {json.dumps(lq_step_stats(it, MAX_IT, rejected, reused))}")

    def queue(fr, h):
        return winfit_cuda.fit_lq_queue_t(fr, *h, 0.0, 1.0, **lq_kw)

    routes = (
        lambda: lq_cuda.fit_t(winfit_cuda.photons_t(
            chunk, *hits_k, BOX, 0.0, 1.0), MAX_IT, FTOL),
        lambda: queue(chunk, hits_k),
        lambda: lq_cuda.fit_t(r, MAX_IT, FTOL),
        lambda: lq_cuda.fit_boundary_t(r, MAX_IT, FTOL),
    )
    lq_route_ms = _turns(routes[i] for i in (0, 1, 1, 0))
    k6_ms = _turns(routes[i] for i in (2, 3, 3, 2))
    ms["K5 lq queue chunk 0"] = _median_ms(lambda: queue(chunk, hits_k))
    chunk_bound = lq_fit_bound(r.shape[-1], float(it.sum()),
                               float(reused.sum()), K5_IN_BYTES)
    full_step = lq_fit_bound(r.shape[-1], float(it.sum()), 0.0, K5_IN_BYTES)
    print(f"chunk 0 lq route ms in turn A gather+K3, B K5 queue, B, A: "
          f"{[round(t, 4) for t in lq_route_ms]}; on the ROIs K3, K6, K6, "
          f"K3: {[round(t, 4) for t in k6_ms]}; K5 queue "
          f"{ms['K5 lq queue chunk 0']:.4f} ms, bound {chunk_bound[0]:.4f} "
          f"ms ({chunk_bound[1]}; "
          f"{chunk_bound[0] / ms['K5 lq queue chunk 0']:.1%} of it; "
          f"full-step bound {full_step[0]:.4f} ms)")
    print(f"chunk 0 lq tail split, queue (ms alone, in turns): "
          f"{json.dumps(lq_tail_split(queue, chunk, hits_k, it))}")
    slow = [h[torch.from_numpy(it == MAX_IT).to(dev)][:1] for h in hits_k]
    if slow[0].numel():
        lat = _median_ms(lambda: queue(chunk, slow))
        print(f"one max_it hit alone ({MAX_IT} steps), queue (cooperative at"
              f" once): {lat:.4f} ms, {lat / MAX_IT * 1e3:.3f} us a step")
    stages = {
        "K4 identify": lambda: identify_cuda.identify_tiles(
            chunk, MIN_NG, BOX),
        "compact": lambda: identify.compact(*tiles, BOX),
        "K5 fit (queue)": lambda: queue(chunk, hits_k),
        "packed chunk + readback": lambda: fused.identify_cut_fit_packed(
            chunk, MIN_NG, 0.0, 1.0, box=BOX, eps=EPS, max_it=MAX_IT,
            method="lq").cpu(),
    }
    print("LQ chunk stages (ms, median of 5):", json.dumps(
        {k: round(_median_ms(fn), 4) for k, fn in stages.items()}))

    # 7. RCC undrift on the card -----------------------------------------
    # the MLE slice's locs with a known drift added: +0.8 px linear in x
    # and a 0.5 px sine in y over the movie; segments of SEGMENTATION
    # frames (16 segments, 120 pairs at 256x256)
    n_frames = len(movie)
    info = [{"Frames": n_frames, "Height": movie.shape[1],
             "Width": movie.shape[2]}]
    t_frame = np.arange(n_frames, dtype=np.float64)
    inj = {"x": 0.8 * t_frame / (n_frames - 1),
           "y": 0.5 * np.sin(2 * np.pi * t_frame / (n_frames - 1))}
    drifted = locs.copy()
    for c in ("x", "y"):
        drifted[c] += inj[c][locs["frame"]].astype(np.float32)
    # the wall split: the steps of postprocess.undrift one by one (the
    # first run on the card, so it includes cuFFT's plan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, segs = postprocess.segment(
        drifted, info, SEGMENTATION,
        {"blur_method": "gaussian", "min_blur_width": 1}, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    crops, offsets = imageprocess.pair_xcorrs(segs, 32)
    t2 = time.perf_counter()
    empty = (segs.sum(dim=(1, 2)) == 0).cpu().numpy()
    imageprocess.peak_shifts(crops, offsets, tuple(segs.shape[1:]), empty)
    t3 = time.perf_counter()
    (drift_g, undrifted), wall_g, launches_undrift = counted(
        lambda: postprocess.undrift(drifted, info, SEGMENTATION,
                                    device="cuda"))
    t4 = time.perf_counter()
    drift_c, _ = postprocess.undrift(drifted, info, SEGMENTATION,
                                     device="cpu")
    wall_c = time.perf_counter() - t4
    if ({k: v for k, v in launches_undrift.items() if v}
            != {"apply_drift records": 1}):
        raise AssertionError("undrift did not launch the record kernel "
                             f"once and nothing else: {launches_undrift}")
    resid, agree = {}, {}
    for c in ("x", "y"):
        d = drift_g[c] - inj[c]
        resid[c] = float(np.sqrt(np.mean((d - d.mean()) ** 2)))
        agree[c] = float(np.abs(drift_g[c] - drift_c[c]).max())
    print(f"undrift {len(drifted)} locs, {len(segs)} segments of "
          f"{SEGMENTATION} frames, {len(crops)} pairs: card {wall_g:.3f} s "
          f"(render {t1 - t0:.3f} s, pair FFTs {t2 - t1:.3f} s, peak fits "
          f"{t3 - t2:.3f} s), CPU {wall_c:.3f} s; residual RMS after the "
          f"offset x {resid['x']:.5f} y {resid['y']:.5f} px; card vs CPU "
          f"max |d drift| x {agree['x']:.3g} y {agree['y']:.3g} px")
    if max(resid.values()) > DRIFT_RESID or max(agree.values()) > DRIFT_AGREE:
        raise AssertionError("undrift did not recover the injected drift or "
                             "disagrees with the CPU")
    if not (np.isfinite(undrifted["x"]).all() and len(undrifted) == len(locs)):
        raise AssertionError("undrift: locs lost or not finite")
    # the record kernel on these locs and this drift: == its plain version
    # on the card bit for bit; its device time, bytes bound and the plain
    # version's time
    layout, table = records.drift_layout(drifted.dtype, drift_g)
    recs = records.upload(drifted, dev)
    table_d = torch.from_numpy(table).to(dev)
    rec_kernel = records.apply_drift_records(recs, layout, table_d)
    rec_plain = records.apply_drift_records_plain(recs, layout, table_d)
    if not torch.equal(rec_kernel, rec_plain):
        raise AssertionError("the record kernel differs from its plain "
                             "version")
    rec_bytes = len(drifted) * (layout.in_size + layout.out_dtype.itemsize)
    rec_entry = {
        "name": "R apply_drift_records (a tile of records staged through "
                "shared memory)", "route": "cuda",
        "source": "picasso_torch/csrc/records.cu",
        "replaces": "none (picasso_tpu/postprocess.py:1351 is pandas)",
        "launches": launches_undrift["apply_drift records"],
        "path": "undrift", "max_abs_err": 0.0,
        "ms": _kernel_device_ms(
            lambda: records.apply_drift_records(recs, layout, table_d),
            "apply_drift_kernel"),
        "plain_ms": _median_ms(lambda: records.apply_drift_records_plain(
            recs, layout, table_d)),
        "bound_ms": rec_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None, "records": len(drifted)}
    del recs, table_d, rec_kernel, rec_plain
    print(f"record kernel, {len(drifted)} records of {layout.in_size} -> "
          f"{layout.out_dtype.itemsize} B: == plain bit for bit, device "
          f"{_ms_or_not(rec_entry['ms'])}, bound {rec_entry['bound_ms']:.4f}"
          f" ms (bytes), plain {rec_entry['plain_ms']:.4f} ms; launches in "
          f"undrift {rec_entry['launches']}")

    # 7a. a drift file ---------------------------------------------------
    # the RCC drift through save_drift and load_drift, applied again:
    # equal to undrift's own locs bit for bit
    drift_dir = tempfile.TemporaryDirectory(prefix=".smoke-drift-", dir=ROOT)
    drift_path = os.path.join(drift_dir.name, "movie_locs_drift.txt")
    io.save_drift(drift_path, drift_g)
    from_file = postprocess.apply_drift(drifted, info,
                                        drift=io.load_drift(drift_path),
                                        device="cuda")
    drift_dir.cleanup()
    for name in undrifted.dtype.names:
        if not np.array_equal(from_file[name], undrifted[name]):
            raise AssertionError(f"drift file: {name} differs from undrift")
    print("drift file: save_drift + load_drift + apply_drift == undrift's "
          "locs bit for bit")

    # 7b. AIM 2D -----------------------------------------------------------
    # aim.aim on the drifted MLE locs (segments of AIM_SEGMENTATION frames,
    # two rounds) on the card, then split into the device counts (each
    # segment's unique + searchsorted over all shifts, through
    # _point_intersect_2d) and the host rest, and on the CPU
    info_aim = [dict(info[0], Pixelsize=camera["Pixelsize"])]
    aim_out, wall_aim, launches_aim = counted(lambda: aim.aim(
        drifted, info_aim, segmentation=AIM_SEGMENTATION, device="cuda"))
    counts_s = [0.0]
    point_2d = aim._point_intersect_2d

    def timed_counts(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = point_2d(*args)
        torch.cuda.synchronize()
        counts_s[0] += time.perf_counter() - t0
        return out

    aim._point_intersect_2d = timed_counts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aim_split = aim.aim(drifted, info_aim, segmentation=AIM_SEGMENTATION,
                        device="cuda")
    wall_split = time.perf_counter() - t0
    aim._point_intersect_2d = point_2d
    t0 = time.perf_counter()
    aim_cpu = aim.aim(drifted, info_aim, segmentation=AIM_SEGMENTATION,
                      device="cpu")
    wall_aim_cpu = time.perf_counter() - t0
    n_seg = -(-n_frames // AIM_SEGMENTATION)
    for got in (aim_out, aim_split):
        for a, b in ((got[0], aim_cpu[0]), (got[2], aim_cpu[2])):
            for name in a.dtype.names:
                if not np.array_equal(a[name], b[name]):
                    raise AssertionError(f"AIM 2D: {name} on the card differs "
                                         "from the CPU")
    resid_aim = {}
    for c in ("x", "y"):
        d = aim_out[2][c] - inj[c]
        resid_aim[c] = float(np.sqrt(np.mean((d - d.mean()) ** 2)))
    if max(resid_aim.values()) > DRIFT_RESID or any(launches_aim.values()):
        raise AssertionError(f"AIM 2D: residual {resid_aim} or a kernel of "
                             f"the localize path launched {launches_aim}")
    print(f"AIM 2D {len(drifted)} locs, {n_seg} segments of "
          f"{AIM_SEGMENTATION} frames, 2 rounds: card {wall_aim:.3f} s "
          f"(again with the split: {wall_split:.3f} s, device counts "
          f"{counts_s[0]:.3f} s, host rest {wall_split - counts_s[0]:.3f} "
          f"s), CPU {wall_aim_cpu:.3f} s; card == CPU bit for bit (drift "
          f"and locs, f32); residual RMS after the offset x "
          f"{resid_aim['x']:.5f} y {resid_aim['y']:.5f} px")

    # 7c. fiducials --------------------------------------------------------
    # N_FIDUCIALS tracks (one loc a frame, 0.01 px) at least 6 px from
    # every loc of the slice, with the same drift, added to the drifted
    # locs; find_fiducials (K4 on the smooth render) and the drift from
    # their picks on the card and the CPU
    centres = free_positions(locs["x"], locs["y"], movie.shape[1],
                             N_FIDUCIALS, 6.0)
    tracks = fiducial_tracks(centres, n_frames, np.random.default_rng(23),
                             dtype=locs.dtype)
    for c in ("x", "y"):
        tracks[c] += inj[c][tracks["frame"]].astype(np.float32)
    with_fid = np.concatenate([drifted, tracks])
    with_fid = with_fid[np.argsort(with_fid["frame"], kind="stable")]
    (picks_g, box_g), wall_find, launches_fid = counted(
        lambda: imageprocess.find_fiducials(with_fid, info_aim,
                                            device="cuda"))
    if launches_fid["K4"] != 1 or sum(launches_fid.values()) != 1:
        raise AssertionError(f"find_fiducials did not run K4 once: "
                             f"{launches_fid}")
    picks_c, _ = imageprocess.find_fiducials(with_fid, info_aim,
                                             device="cpu")
    found = sum(bool(picks_g) and np.hypot(
        *(np.asarray(picks_g, float) - c).T).min() < 1.5 for c in centres)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fid_g = postprocess.undrift_from_fiducials(with_fid, info_aim,
                                               device="cuda")
    wall_fid = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid_c = postprocess.undrift_from_fiducials(with_fid, info_aim,
                                               device="cpu")
    wall_fid_cpu = time.perf_counter() - t0
    agree_fid = max(float(np.abs(fid_g[2][c] - fid_c[2][c]).max())
                    for c in ("x", "y"))
    resid_fid = {}
    for c in ("x", "y"):
        d = fid_g[2][c] - inj[c]
        resid_fid[c] = float(np.sqrt(np.mean((d - d.mean()) ** 2)))
    print(f"fiducials: {N_FIDUCIALS} tracks added ({len(with_fid)} locs); "
          f"find_fiducials {wall_find:.3f} s on the card, {len(picks_g)} "
          f"picks (box {box_g}), {found} of {N_FIDUCIALS} fiducials among "
          f"them, picks card == CPU {picks_g == picks_c}; undrift from "
          f"fiducials card {wall_fid:.3f} s, CPU {wall_fid_cpu:.3f} s; card "
          f"vs CPU max |d drift| {agree_fid:.3g} px; residual RMS after the "
          f"offset x {resid_fid['x']:.5f} y {resid_fid['y']:.5f} px")
    if (found != N_FIDUCIALS or picks_g != picks_c or agree_fid > FID_AGREE
            or max(resid_fid.values()) > FID_RESID):
        raise AssertionError("fiducials: not all found, card and CPU "
                             "disagree, or the drift is not recovered")

    # 7d. render -----------------------------------------------------------
    # the undrifted (f64) locs at oversampling RENDER_OVERSAMPLING with
    # every blur: the card's ms (median of 5 render calls, upload and
    # readback included; and render_t alone on the columns on the card)
    # against one CPU call; the histogram equal to the CPU's, every blur
    # within RENDER_AGREE of the CPU image's max
    render_ms = {}
    on_card = render.columns(undrifted, ("x", "y", "lpx", "lpy"), dev)
    for blur in (None, "gaussian", "gaussian_iso", "smooth", "convolve"):
        def card(blur=blur):
            return render.render(undrifted, info, RENDER_OVERSAMPLING,
                                 blur_method=blur, device="cuda")

        n_g, img_g = card()
        render_ms[str(blur)] = _median_ms(card)
        device_ms = _median_ms(lambda blur=blur: render.render_t(
            on_card, info, RENDER_OVERSAMPLING, blur_method=blur))
        t0 = time.perf_counter()
        n_c, img_c = render.render(undrifted, info, RENDER_OVERSAMPLING,
                                   blur_method=blur, device="cpu")
        wall_c = time.perf_counter() - t0
        rel = float(np.abs(img_g - img_c).max() / img_c.max())
        print(f"render {blur}: {n_g} locs into {img_g.shape}: card "
              f"{render_ms[str(blur)]:.3f} ms (render_t on the card's "
              f"columns {device_ms:.3f} ms), CPU {wall_c:.3f} s; max|d|/max "
              f"{rel:.3g}, equal {np.array_equal(img_g, img_c)}")
        if n_g != n_c or not np.isfinite(img_g).all() or (
                rel > RENDER_AGREE[str(blur)]):
            raise AssertionError(f"render {blur}: the card differs from the "
                                 "CPU")

    # 8. the TIFF series -------------------------------------------------
    # the movie as MicroManager writes a long series, movie.ome.tif +
    # movie_1.ome.tif (1024 frames each), in a folder of the checkout
    # removed at the end; the decode rate is read from the page cache
    # right after the write
    tiff_dir = tempfile.TemporaryDirectory(prefix=".smoke-tiff-", dir=ROOT)
    half = len(movie) // 2
    t0 = time.perf_counter()
    write_tiff(os.path.join(tiff_dir.name, "movie.ome.tif"), movie[:half])
    write_tiff(os.path.join(tiff_dir.name, "movie_1.ome.tif"), movie[half:])
    t1 = time.perf_counter()
    lazy, lazy_info = io.load_movie(os.path.join(tiff_dir.name,
                                                 "movie.ome.tif"))
    decoded = lazy[0:len(lazy)]
    t2 = time.perf_counter()
    if not np.array_equal(decoded, movie) or lazy_info[0]["Frames"] != len(
            movie):
        raise AssertionError("TIFF series: frames differ from the movie")
    del decoded
    mb = movie.nbytes / 1e6
    locs_tif, wall_tif, launches_tif = run_slice("gaussmle", src=lazy)
    check_route("MLE slice (TIFF series)", launches_tif, "K5 mle queue", 2)
    for name in locs.dtype.names:
        if not np.array_equal(locs_tif[name], locs[name], equal_nan=True):
            raise AssertionError(f"TIFF series slice: {name} differs from "
                                 "the in-RAM slice")
    # the in-RAM and the TIFF slice in turns (A B B A)
    tif_walls = [run_slice("gaussmle", src=s)[1]
                 for s in (None, lazy, lazy, None)]
    print(f"TIFF series (2 files, {mb:.1f} MB): write {t1 - t0:.3f} s, "
          f"decode {t2 - t1:.3f} s = {mb / (t2 - t1):.0f} MB/s; MLE slice "
          f"on it == the in-RAM slice bit for bit ({len(locs_tif)} locs); "
          f"walls in turn RAM, TIFF, TIFF, RAM: "
          f"{[round(w, 3) for w in tif_walls]} s")

    # 9. avg on the in-RAM movie and on the TIFF series ------------------
    avg_runs = {}
    for what, src in (("RAM", movie), ("TIFF", lazy)):
        avg_runs[what] = counted(lambda src=src: localize.localize(
            src, dict(camera), params, fitting_method="avg", device="cuda"))
        check_route(f"avg ({what})", avg_runs[what][2], None)
    locs_avg = avg_runs["RAM"][0]
    for c in ("frame", "x", "y", "net_gradient"):
        if not np.array_equal(locs_avg[c], mle_ids[c]):
            raise AssertionError(f"avg: hit list ({c}) differs from the MLE "
                                 "slice's")
    for name in locs_avg.dtype.names:
        if not np.array_equal(avg_runs["TIFF"][0][name], locs_avg[name],
                              equal_nan=True):
            raise AssertionError(f"avg: {name} differs between the in-RAM "
                                 "movie and the TIFF series")
    # chunk 0 on the CPU: the same sums (f64, rounded once) from the
    # same ROIs, and within compare_avg_photons of the f32 pairwise sum
    # picasso_tpu takes
    first = locs_avg["frame"] < CHUNK
    ids0 = mle_ids[mle_ids["frame"] < CHUNK]
    spots0 = localize.get_spots(movie, ids0, BOX, dict(camera), device="cpu")
    cpu0 = avgroi.fit_spots(spots0, device="cpu")[:, 2]
    if not np.array_equal(locs_avg["photons"][first], cpu0):
        raise AssertionError("avg: chunk 0 photons differ from the CPU run")
    avg_err = compare_avg_photons(
        np.sum(spots0, axis=(1, 2)), locs_avg["photons"][first], spots0,
        "avg chunk 0 vs the f32 pairwise sum")
    print(f"avg: {len(locs_avg)} locs, hit list == the MLE slice's, TIFF "
          f"series == in RAM bit for bit, chunk 0 photons == the CPU run "
          f"({first.sum()} spots; |d| / sum|pixel| against the f32 pairwise "
          f"sum {avg_err:.3g}); walls RAM {avg_runs['RAM'][1]:.3f} s, TIFF "
          f"{avg_runs['TIFF'][1]:.3f} s; launches {avg_runs['RAM'][2]}")
    del spots0

    # 10. identify + fit2D (K2 for MLE, K3 for LM) -------------------------
    ids, wall_id, launches_id = counted(
        lambda: localize.identify(movie, MIN_NG, BOX, device="cuda"))
    check_route("identify", launches_id, None)
    for c in ids.dtype.names:
        if not np.array_equal(ids[c], mle_ids[c]):
            raise AssertionError(f"identify: {c} differs from the fused "
                                 "slice's hit list")
    info2d = [{"Frames": len(movie), "Height": movie.shape[1],
               "Width": movie.shape[2]}]
    (fit_mle, _), wall_k2, launches_k2 = counted(lambda: localize.fit2D(
        movie, info2d, dict(camera), ids, BOX, fitting_method="gaussmle",
        device="cuda"))
    # the launches follow the routes of ops/mle_cuda.ROI_FITS and
    # ops/lq_cuda.ROI_FIT: K1 1 a block, K2's phases 3, the LM (queue or
    # one pass) 1
    k2_key, per_block = {
        mle_cuda.fit_t: ("K1", 1),
        mle_cuda.fit_boundary_t: ("K2", 3)}[mle_cuda.ROI_FITS["sigmaxy"]]
    n_k2 = per_block * -(-len(ids) // gaussmle._CHUNK)
    if (launches_k2[k2_key] != n_k2
            or any(v for k, v in launches_k2.items() if k != k2_key)):
        raise AssertionError(f"fit2D MLE did not run through {k2_key} only:"
                             f" {launches_k2}")
    for name in locs.dtype.names:
        if not np.array_equal(fit_mle[name], locs[name], equal_nan=True):
            raise AssertionError(f"fit2D MLE ({k2_key}): {name} differs from"
                                 " the fused MLE slice (K5 queue)")
    (fit_lq, _), wall_k3, launches_k3 = counted(lambda: localize.fit2D(
        movie, info2d, dict(camera), ids, BOX, fitting_method="gausslq",
        device="cuda"))
    k3_key = "K3 queue" if lq_cuda.ROI_FIT is lq_cuda.fit_queue_t else "K3"
    n_k3 = -(-len(ids) // lq._CHUNK)
    if (launches_k3[k3_key] != n_k3
            or any(v for k, v in launches_k3.items() if k != k3_key)):
        raise AssertionError(f"fit2D LQ did not run through {k3_key} only: "
                             f"{launches_k3}")
    # K3 at picasso_tpu's fit2D max_it 30 against K5's LM queue at 30 on
    # the same hits (one chunk of the whole movie), and against the LQ
    # slice (max_it 100) on the spots that converge within 30 steps
    whole = identify.upload_frames(movie, dev)
    hits_all = [torch.from_numpy(np.ascontiguousarray(ids[c])).to(dev)
                for c in ("frame", "y", "x")]
    lq30, lq100 = (winfit_cuda.fit_lq_queue_t(
        whole, *hits_all, 0.0, 1.0, box=BOX, max_it=m, ftol=FTOL
    ).cpu().numpy() for m in (30, MAX_IT))
    del whole, hits_all
    ref30 = gausslq.locs_from_fits(ids, lq30.T, BOX, False)
    for name in ref30.dtype.names:
        if not np.array_equal(fit_lq[name], ref30[name], equal_nan=True):
            raise AssertionError(f"fit2D LQ (K3): {name} differs from K5's "
                                 "LM queue at max_it 30")
    conv = np.all((lq30 == lq100) | (np.isnan(lq30) & np.isnan(lq100)), 0)
    if not (conv.mean() >= 0.98 and all(np.array_equal(
            fit_lq[c][conv], locs_lq[c][conv], equal_nan=True)
            for c in ("x", "y", "photons", "sx", "sy", "bg"))):
        raise AssertionError("fit2D LQ: differs from the LQ slice on the "
                             "spots that converge within 30 steps")
    print(f"identify ({wall_id:.3f} s, launches {launches_id}) == the fused "
          f"slice's {len(ids)} hits; fit2D gaussmle ({k2_key}, "
          f"{launches_k2[k2_key]} launches, {wall_k2:.3f} s) == the fused "
          f"MLE slice bit for bit; fit2D gausslq ({k3_key}, "
          f"{launches_k3[k3_key]} launches, {wall_k3:.3f} s, max_it 30) == "
          f"K5 LM queue at max_it 30 bit for bit, == the LQ slice on the "
          f"{conv.mean():.4%} of spots that converge within 30 steps")

    # the first fit2D block (262,144 ROIs, cut and converted as
    # gaussmle.gaussmle does): K1 and K2's phases == the one-thread pass
    # bit for bit (MLE at max_it MAX_IT and STRAGGLER_IT), the ROI LM
    # queue == K3 and K6 (at 30 and MAX_IT); the card's MLE fits against
    # the plain fit (sigmaxy within compare_fits, sigma, on these dense
    # ROIs, within compare_fits_dense), here and on the later blocks,
    # which played no part in choosing the fit body's roundings; the
    # routes in ROUTE_TURNS alternating turns, which set
    # ops/mle_cuda.ROI_FITS (the lower median of K2's phases and K1) and
    # ops/lq_cuda.ROI_FIT (the queue iff its median is lower); each
    # kernel's ms, bound and plain ms; the MLE straggler tail: the max_it
    # spots alone
    def cut_block(k):
        raw = localize.get_spots_raw(
            movie, ids[k * gaussmle._CHUNK:(k + 1) * gaussmle._CHUNK], BOX,
            device="cuda")
        return identify.as_float32(torch.from_numpy(raw).to(dev)).permute(
            1, 2, 0).contiguous()

    def hold_to_plain(what, plain, card, method):
        """sigmaxy within compare_fits, sigma within compare_fits_dense
        (and whether also within compare_fits)."""
        gate = compare_fits if method == "sigmaxy" else compare_fits_dense
        out = gate(plain, card, MAX_IT, f"{what} {method}: the card vs plain")
        try:
            compare_fits(plain, card, MAX_IT)
            tight = True
        except AssertionError:
            tight = False
        print(f"{what} {method}: the card vs plain ({gate.__name__}; within "
              f"compare_fits: {tight}):", json.dumps(out))
        return out

    block = cut_block(0)
    nb = block.shape[-1]
    fit2d = {}
    mle_routes = {"K2 phases": mle_cuda.fit_boundary_t, "K1": mle_cuda.fit_t}
    for method in ("sigmaxy", "sigma"):
        tag = "" if method == "sigmaxy" else " sigma"
        coop = {}
        for m in (MAX_IT, STRAGGLER_IT):
            c1 = torch.zeros(1, dtype=torch.int32, device=dev)
            one = as_np(mle_cuda.fit_one_pass_t(block, EPS, m, method))
            k1b = as_np(mle_cuda.fit_t(block, EPS, m, method, coop_steps=c1))
            _assert_equal(k1b, one, f"fit2D block {method} max_it {m}: K1 "
                          "vs the one pass")
            _assert_equal(as_np(mle_cuda.fit_boundary_t(block, EPS, m,
                                                        method)), one,
                          f"fit2D block {method} max_it {m}: K2 vs the one "
                          "pass")
            coop[m] = {"K1": int(c1.item()),
                       "at max_it": float(np.mean(one[3] == m))}
            if m == MAX_IT:
                it_b = one[3]
                stats["K1 fit2D" + tag] = hold_to_plain(
                    "fit2D block", as_np(mle._fit_core(block, EPS, MAX_IT,
                                                       method)), k1b, method)
        turns = _alternate([(lambda f=f: f(block, EPS, MAX_IT, method))
                            for f in mle_routes.values()], ROUTE_TURNS)
        med = {k: statistics.median(t) for k, t in zip(mle_routes, turns)}
        ms["K2 fit2D" + tag] = med["K2 phases"]
        ms["K1 fit2D" + tag] = med["K1"]
        bounds["fit2D" + tag] = _fit_bound(nb, float(it_b.sum()),
                                           mle_flops_per_spot_iter, 56)
        ms["plain fit2D" + tag] = _median_ms(
            lambda: mle._fit_core(block, EPS, MAX_IT, method))
        at_max = torch.from_numpy(it_b == MAX_IT).to(dev)
        stuck = block[:, :, at_max].contiguous()
        tail = [round(t, 4) for t in _turns(
            [(lambda f=f: f(stuck, EPS, MAX_IT, method))
             for f in (mle_cuda.fit_boundary_t, mle_cuda.fit_t,
                       mle_cuda.fit_t, mle_cuda.fit_boundary_t)])]
        fit2d[method] = {
            "turns_ms": {k: [round(t, 4) for t in v]
                         for k, v in zip(mle_routes, turns)},
            "route": min(med, key=med.get),
            "route_set": next(k for k, f in mle_routes.items()
                              if f is mle_cuda.ROI_FITS[method]),
            "tail_split_ms": {"spots at max_it": int(at_max.sum()),
                              "alone K2, K1, K1, K2": tail},
        }
        b_ms = bounds["fit2D" + tag][0]
        print(f"fit2D block {method} ({nb} ROIs, iterations mean "
              f"{it_b.mean():.2f}, {np.mean(it_b == MAX_IT):.4f} at max_it): "
              f"K1, K2 == the one pass bit for bit at max_it {MAX_IT} and "
              f"{STRAGGLER_IT} (cooperative steps, share at max_it: "
              f"{json.dumps(coop)}); medians of {ROUTE_TURNS} turns: K2 "
              f"phases {med['K2 phases']:.4f} ms, K1 {med['K1']:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_ms / med['K1']:.1%} of K1, "
              f"{b_ms / med['K2 phases']:.1%} of the phases), plain "
              f"{ms['plain fit2D' + tag]:.3f} ms;", json.dumps(fit2d[method]))
    for k in range(1, -(-len(ids) // gaussmle._CHUNK)):
        later = cut_block(k)
        for method in ("sigmaxy", "sigma"):
            hold_to_plain(f"fit2D block {k + 1} ({later.shape[-1]} ROIs)",
                          as_np(mle._fit_core(later, EPS, MAX_IT, method)),
                          as_np(mle_cuda.fit_t(later, EPS, MAX_IT, method)),
                          method)
        del later
    for m in (30, MAX_IT):
        c = torch.zeros(1, dtype=torch.int32, device=dev)
        q = lq_cuda.fit_queue_t(block, m, FTOL, coop_steps=c).cpu().numpy()
        for other in (lq_cuda.fit_t, lq_cuda.fit_boundary_t):
            if not np.array_equal(q, other(block, m, FTOL).cpu().numpy(),
                                  equal_nan=True):
                raise AssertionError(f"fit2D block max_it {m}: K3 queue != "
                                     f"{other.__name__}")
        if m == 30:
            coop_lq = int(c.item())
            stats["K3 queue fit2D"] = compare_lq_fits(
                lq._lm_core(block, 30, FTOL).cpu().numpy(), q,
                block.cpu().numpy(), "fit2D block: K3 queue vs plain")
    fns = (lambda: lq_cuda.fit_t(block, 30, FTOL),
           lambda: lq_cuda.fit_queue_t(block, 30, FTOL),
           lambda: lq_cuda.fit_boundary_t(block, 30, FTOL))
    turns = _alternate(fns, ROUTE_TURNS)
    ms["K3 fit2D"], ms["K3 queue fit2D"], ms["K6 fit2D"] = (
        statistics.median(t) for t in turns)
    it30, _, reused30 = lq_iters(block, 30)
    bounds["fit2D lq"] = lq_fit_bound(nb, float(it30.sum()),
                                      float(reused30.sum()))
    ms["plain fit2D lq"] = _median_ms(lambda: lq._lm_core(block, 30, FTOL))
    fit2d["lq"] = {
        "turns_ms": {"K3": [round(t, 4) for t in turns[0]],
                     "K3 queue": [round(t, 4) for t in turns[1]],
                     "K6": [round(t, 4) for t in turns[2]]},
        "route": ("queue" if ms["K3 queue fit2D"] < ms["K3 fit2D"]
                  else "one pass"),
        "route_set": ("queue" if lq_cuda.ROI_FIT is lq_cuda.fit_queue_t
                      else "one pass"),
        "steps": lq_step_stats(it30, 30)}
    b_ms = bounds["fit2D lq"][0]
    print(f"fit2D block LM at max_it 30: K3 queue == K3 == K6 bit for bit "
          f"at max_it 30 and {MAX_IT} (cooperative steps at 30: {coop_lq});"
          f" K3 {ms['K3 fit2D']:.4f} ms, queue {ms['K3 queue fit2D']:.4f} ms"
          f", K6 {ms['K6 fit2D']:.4f} ms"
          f" (medians of {ROUTE_TURNS} turns), bound {b_ms:.4f} ms "
          f"({b_ms / ms['K3 queue fit2D']:.1%} of the queue, "
          f"{b_ms / ms['K3 fit2D']:.1%} of K3), plain "
          f"{ms['plain fit2D lq']:.3f} ms;", json.dumps(fit2d["lq"]))
    for what, r in fit2d.items():
        if r["route"] != r["route_set"]:
            print(f"note: fit2D {what}: this run's turns favour the "
                  f"{r['route']}, the route constant takes the "
                  f"{r['route_set']}")
    del block, stuck
    del fit_mle, fit_lq, locs_tif

    # 11. astigmatic 3D ---------------------------------------------------
    (astig, sites, z_true), astig_s = astig_job.result()
    print(f"astigmatic movie {astig.shape}: {astig_s:.1f} s to generate "
          "(alongside the build)")
    from scipy.spatial import cKDTree

    tree = cKDTree(sites[:, ::-1].astype(np.float64))
    info3d = [{"Frames": len(astig), "Height": astig.shape[1],
               "Width": astig.shape[2], "Pixelsize": camera["Pixelsize"]}]
    paths3d, locs3d_by = {}, {}
    for method, fit, per_chunk in (("gaussmle", "K5 mle queue", 2),
                                   ("gausslq", "K5 lq queue", 1)):
        (locs3d, info_out), wall3d, launches3d = counted(
            lambda method=method: localize.localize_3D(
                astig, movie_info=info3d, camera_info=dict(camera), box=BOX,
                minimum_ng=MIN_NG, calibration_3d=CALIB_3D,
                fitting_method=method, device="cuda"))
        check_route(f"localize_3D {method}", launches3d, fit, per_chunk)
        paths3d[method] = launches3d
        locs3d_by[method] = locs3d
        locs2d = localize.localize(astig, dict(camera), params,
                                   fitting_method=method, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zfit.zfit(locs2d, info3d, calibration=CALIB_3D,
                  fitting_method=method, filter=0, device="cuda")
        wall_z = time.perf_counter() - t0
        # the card against the CPU on chunk 0's locs, filter off
        rows = locs2d[locs2d["frame"] < CHUNK]
        z_card, z_cpu = (zfit.zfit(rows, info3d, calibration=CALIB_3D,
                                   fitting_method=method, filter=0,
                                   device=d)[0] for d in ("cuda", "cpu"))
        for name in z_card.dtype.names:
            if not np.array_equal(z_card[name], z_cpu[name], equal_nan=True):
                raise AssertionError(f"zfit {method}: {name} on the card "
                                     "differs from the CPU")
        kept = len(locs3d) / len(locs2d)
        dist, k = tree.query(np.stack([locs3d["x"], locs3d["y"]], 1),
                             distance_upper_bound=1.0)
        near = np.isfinite(dist)
        err = locs3d["z"][near] - z_true[k[near]]
        rms, med = float(np.sqrt(np.mean(err**2))), float(
            np.median(np.abs(err)))
        # bounds from the CPU run at this density (PERF.md): kept MLE
        # 0.911 / LQ 0.989, z RMS 102.7 / 118.2 nm, median 13.2 / 11.4
        bound = Z_BOUNDS[method]
        if not (kept >= bound[0] and rms < bound[1] and med < bound[2]
                and np.isfinite(locs3d["z"]).all()):
            raise AssertionError(
                f"localize_3D {method}: kept {kept:.4f}, z RMS {rms:.1f} nm, "
                f"median {med:.1f} nm against the bounds {bound}")
        if info_out[-1]["Generated by"] != "Picasso v0.1.0 Fit Z":
            raise AssertionError("localize_3D: no Fit Z block in the info")
        # RCC undrift keeps z, d_zcalib and lpz of every loc
        _, und = postprocess.undrift(locs3d, info3d, SEGMENTATION,
                                     device="cuda")
        if not (len(und) == len(locs3d) and all(
                np.array_equal(und[c], locs3d[c], equal_nan=True)
                for c in ("frame", "z", "d_zcalib", "lpz"))):
            raise AssertionError("undrift of the 3D locs lost z")
        print(f"localize_3D {method}: {len(locs3d)} locs of {len(locs2d)} "
              f"({kept:.4f}) in {wall3d:.3f} s, launches {launches3d}; zfit "
              f"of {len(locs2d)} locs on the card {wall_z:.3f} s (rows a "
              f"block {zfit.Z_ROWS}); chunk 0's {len(rows)} locs: card == "
              f"CPU bit for bit; z against the truth ({near.sum()} locs "
              f"within 1 px of a site): RMS {rms:.1f} nm, median |d| "
              f"{med:.1f} nm; undrift keeps z, d_zcalib, lpz")
    # 12. AIM 3D ---------------------------------------------------------
    # aim.aim on the localize_3D MLE locs with the x/y drift of phase 7
    # and a z drift of AIM_Z_DRIFT nm (a sine over the movie), on the card
    # and the CPU; the z residual under the bound from the CPU run
    locs3d = locs3d_by["gaussmle"]
    inj_z = AIM_Z_DRIFT * np.sin(2 * np.pi * t_frame / (n_frames - 1))
    drifted3d = locs3d.copy()
    for c, d in (("x", inj["x"]), ("y", inj["y"]), ("z", inj_z)):
        drifted3d[c] += d[locs3d["frame"]].astype(np.float32)
    aim3d, wall_aim3d, launches_aim3d = counted(lambda: aim.aim(
        drifted3d, info3d, segmentation=AIM_SEGMENTATION, device="cuda"))
    t0 = time.perf_counter()
    aim3d_cpu = aim.aim(drifted3d, info3d, segmentation=AIM_SEGMENTATION,
                        device="cpu")
    wall_aim3d_cpu = time.perf_counter() - t0
    for a, b in ((aim3d[0], aim3d_cpu[0]), (aim3d[2], aim3d_cpu[2])):
        for name in a.dtype.names:
            if not np.array_equal(a[name], b[name], equal_nan=True):
                raise AssertionError(f"AIM 3D: {name} on the card differs "
                                     "from the CPU")
    resid3d = {}
    for c, want in (("x", inj["x"]), ("y", inj["y"]), ("z", inj_z)):
        d = aim3d[2][c] - want
        resid3d[c] = float(np.sqrt(np.mean((d - d.mean()) ** 2)))
    print(f"AIM 3D {len(drifted3d)} locs (localize_3D MLE), z drift "
          f"{AIM_Z_DRIFT} nm sine: card {wall_aim3d:.3f} s, CPU "
          f"{wall_aim3d_cpu:.3f} s; card == CPU bit for bit; residual RMS "
          f"after the offset x {resid3d['x']:.5f} y {resid3d['y']:.5f} px, "
          f"z {resid3d['z']:.3f} nm")
    if (max(resid3d["x"], resid3d["y"]) > DRIFT_RESID
            or resid3d["z"] > AIM_Z_RESID or any(launches_aim3d.values())):
        raise AssertionError(f"AIM 3D: residual {resid3d} against the "
                             f"bounds ({DRIFT_RESID} px, {AIM_Z_RESID} nm)")
    # 13. link -> dark -> groupprops, on the undrifted MLE locs ----------
    t13 = time.perf_counter()
    events, launches_link, _ = link_phase(undrifted, info, bench_sites,
                                          counted, smi)
    # 14. the statistics (the FFTs of the full field want the memory that
    # earlier phases left reserved) ------------------------------------------
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    stats_phase(undrifted, info, events, smi)
    print(f"phases 13-14: {t14 - t13:.1f} s and "
          f"{time.perf_counter() - t14:.1f} s ({smi})")
    # 15. the checks of localize -db, and a summary row ------------------
    t15 = time.perf_counter()
    launches_db, _ = db_phase(undrifted, info, counted, smi)
    # 16. align_rcc on two channels --------------------------------------
    t16 = time.perf_counter()
    align_phase(undrifted, info, bench_sites, smi)
    # 17. clustering -----------------------------------------------------
    t17 = time.perf_counter()
    launches_cl, _ = cluster_phase(undrifted, info, locs3d_by["gaussmle"],
                                   info3d, bench_sites, counted, smi)
    # 18. the analyses of grouped locs: G5M and averaging ---------------
    t18 = time.perf_counter()
    launches_g5m, launches_avg, origami = origami_phase(counted, smi)
    # 19. SPINNA ----------------------------------------------------------
    t19 = time.perf_counter()
    launches_spinna = spinna_phase(counted, smi)
    # 20. the localize API, simulate, nanotron, average3 ----------------
    t20 = time.perf_counter()
    launches_api = localize_api_phase(movie, locs, ids, camera, params,
                                      counted, smi)
    t20b = time.perf_counter()
    launches_sim = simulate_phase(counted, smi)
    t20c = time.perf_counter()
    launches_nano = nanotron_phase(counted, smi)
    t20d = time.perf_counter()
    launches_avg3 = average3_phase(counted, smi)
    t21 = time.perf_counter()
    # 21. the pick analyses and the Mask tool -----------------------------
    launches_picks, launches_mask = picks_phase(counted, smi)
    t22 = time.perf_counter()
    # 22. rotated and 3D renders, the scene, the render index, exports --
    torch.cuda.empty_cache()
    launches_r3d = render3d_phase(locs3d_by["gaussmle"], locs3d_by["gausslq"],
                                  info3d, undrifted, info, counted, smi)
    t23 = time.perf_counter()
    # 23. several devices in one process ----------------------------------
    launches_mesh = mesh_phase(movie, camera, segs, origami, counted, smi)
    t24 = time.perf_counter()
    print(f"phase 23: {t24 - t23:.1f} s ({smi})")
    # 24. the folder watcher ---------------------------------------------
    launches_watch = watcher_phase(movie, counted, check_route, smi)
    t25 = time.perf_counter()
    print(f"phase 24: {t25 - t24:.1f} s ({smi})")
    # 25. the render window's frame and the movie browser's calls --------
    launches_rgui = render_gui_phase(undrifted, locs_lq, info, bench_sites,
                                     counted, smi)
    t25b = time.perf_counter()
    launches_lgui = localize_gui_phase(movie, locs_lq, counted, n_chunks,
                                       smi)
    print(f"phase 25: {time.perf_counter() - t25:.1f} s ((a) render-gui "
          f"{t25b - t25:.1f}, (b) localize-gui "
          f"{time.perf_counter() - t25b:.1f}) ({smi})")
    # 26. every box: box 17 and 21 on the wide movie, box 3 and the
    # any-box kernels bit for bit ----------------------------------------
    wide, wide_s = wide_job.result()
    timed_spots = timed_job.result()
    movie_pool.shutdown()
    print(f"wide movie {wide.shape} {wide.dtype}: {wide_s:.1f} s to "
          "generate (alongside the build)")
    torch.cuda.empty_cache()
    launches_any, ms_any, bounds_any, errs_any = anybox_phase(
        wide, chunk, timed_spots, movie, counted, smi)
    ms.update(ms_any)
    bounds.update(bounds_any)
    del wide, timed_spots
    print(f"phases 15-16: {t16 - t15:.1f} s and {t17 - t16:.1f} s, phase "
          f"17: {t18 - t17:.1f} s, phase 18: {t19 - t18:.1f} s, phase 19: "
          f"{t20 - t19:.1f} s, phase 20: {t21 - t20:.1f} s ((a) "
          f"{t20b - t20:.1f}, (b) {t20c - t20b:.1f}, (c) {t20d - t20c:.1f}, "
          f"(d) {t21 - t20d:.1f}), phase 21: {t22 - t21:.1f} s, phase 22: "
          f"{t23 - t22:.1f} s ({smi})")
    print("host code (no kernel):", json.dumps([{
        "name": "link_walk", "source": "picasso_torch/csrc/link_walk.cu",
        "replaces": "picasso_tpu/native/picasso_native.cpp:38",
        "launches": launches_link["link walk"] + launches_db["link walk"]
        + launches_picks["link walk"]}, {
        "name": "cluster_sweep",
        "source": "picasso_torch/csrc/cluster_sweep.cu",
        "replaces": "picasso_tpu/native/picasso_native.cpp:392",
        "launches": launches_cl["cluster sweep"]}]))
    tiff_dir.cleanup()
    paths = {"mle": launches_mle, "mle-sigma": launches_sig,
             "lq": launches_lq, "tiff": launches_tif,
             "avg": avg_runs["RAM"][2], "avg-tiff": avg_runs["TIFF"][2],
             "identify": launches_id, "fiducials": launches_fid,
             "fit2D-mle": launches_k2,
             "fit2D-lq": launches_k3, "3d-mle": paths3d["gaussmle"],
             "3d-lq": paths3d["gausslq"], "link": launches_link,
             "db": launches_db, "cluster": launches_cl,
             "g5m": launches_g5m, "average": launches_avg,
             "spinna": launches_spinna, **launches_api,
             "simulate": launches_sim, "nanotron": launches_nano,
             "average3": launches_avg3, "picks": launches_picks,
             "mask": launches_mask, "render3d": launches_r3d,
             **launches_mesh, "watcher": launches_watch,
             "render-gui": launches_rgui, "localize-gui": launches_lgui,
             **launches_any}
    for path in ("simulate", "nanotron", "average3", "mask", "render3d",
                 "render-gui"):
        if any(paths[path].values()):
            raise AssertionError(f"path {path} launched {paths[path]}")
    if any(v for k, v in launches_picks.items() if k != "link walk"):
        raise AssertionError(f"path picks launched {launches_picks}")
    fit_key = {mle_cuda.fit_t: "K1", mle_cuda.fit_boundary_t: "K2"}[
        mle_cuda.ROI_FITS["sigmaxy"]]
    for path in ("fit", "camera-array"):
        if not paths[path][fit_key] or (path == "camera-array"
                                        and paths[path]["K4"] != n_chunks):
            raise AssertionError(f"path {path} did not run through "
                                 f"{fit_key}: {paths[path]}")
    print("launches by path:", json.dumps(paths))

    # the kernels line -----------------------------------------------------
    def entry(key, name, source, replaces, counter, err, plain,
              method=None):
        """One kernel's record; its launches are those of ``counter`` on
        every path, or, for an MLE fit of one ``method``, on the paths
        of that method (the counters are shared by both methods)."""
        on = {p: v.get(counter, 0) for p, v in paths.items()
              if method is None
              or p.endswith("-sigma") == (method == "sigma")}
        b_ms, b_by = bounds[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(on.values()),
                "path": "+".join(p for p, v in on.items() if v) or "off",
                "max_abs_err": err, "ms": ms[key], "plain_ms": ms[plain],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    mle_src, lq_src = ("picasso_torch/csrc/mle_fit.cu",
                       "picasso_torch/csrc/lq_fit.cu")
    win_src = "picasso_torch/csrc/winfit_mle.cu"
    fit_src = "picasso_torch/csrc/roi_mle_fit.cu"
    queue_src = "picasso_torch/csrc/winfit_mle_queue.cu"
    win_tpu = "picasso_tpu/ops/winfit_pallas.py:108"
    kernels = [
        entry("K5 queue", "K5 winfit_mle_queue sigmaxy (work queue + "
              "CRLB/LL pass)", queue_src, win_tpu, "K5 mle queue",
              stats["K5 queue"]["xy_max_all"], "plain K5", "sigmaxy"),
        entry("K5 queue sigma", "K5 winfit_mle_queue sigma (work queue + "
              "CRLB/LL pass)", queue_src, win_tpu, "K5 mle queue",
              stats["K5 queue sigma"]["xy_max_all"], "plain K5 sigma",
              "sigma"),
        entry("K5", "K5 winfit_mle sigmaxy (phases 16/50/100)", win_src,
              win_tpu, "K5 mle phases", stats["K5"]["xy_max_all"],
              "plain K5", "sigmaxy"),
        entry("K5 sigma", "K5 winfit_mle sigma (phases 16/50/100)", win_src,
              win_tpu, "K5 mle phases", stats["K5 sigma"]["xy_max_all"],
              "plain K5 sigma", "sigma"),
        entry("K5 lq queue", "K5 winfit_lq_queue (work queue, cooperative "
              "tail)", "picasso_torch/csrc/winfit_lq_queue.cu",
              "picasso_tpu/ops/winfit_pallas.py:96", "K5 lq queue",
              stats["K5 lq queue"]["xy_p100"], "plain K5 lq"),
        entry("K4", "K4 identify_tiles", "picasso_torch/csrc/identify.cu",
              "picasso_tpu/ops/identify_pallas.py:58", "K4", k4_err,
              "plain K4"),
        entry("K5 one pass", "K5 winfit_mle sigmaxy (single pass)", win_src,
              win_tpu, "K5 mle one pass", stats["K1 one pass"]["xy_max_all"],
              "plain K5", "sigmaxy"),
        entry("K5 one pass sigma", "K5 winfit_mle sigma (single pass)",
              win_src, win_tpu, "K5 mle one pass",
              stats["K1 one pass sigma"]["xy_max_all"], "plain K5 sigma",
              "sigma"),
        entry("K3 queue", "K3 roi_lq_queue (work queue, cooperative tail)",
              "picasso_torch/csrc/roi_lq_queue.cu",
              "picasso_tpu/ops/lq_pallas.py:25", "K3 queue",
              stats["K3 queue"]["xy_p100"], "plain_lq"),
        entry("K2", "K2 mle_fit sigmaxy (phases 16/50/100)", mle_src,
              "picasso_tpu/ops/mle_pallas.py:256", "K2",
              stats["K2"]["xy_max_all"], "plain_fit", "sigmaxy"),
        entry("K2 sigma", "K2 mle_fit sigma (phases 16/50/100)", mle_src,
              "picasso_tpu/ops/mle_pallas.py:256", "K2",
              stats["K2 sigma"]["xy_max_all"], "plain_fit sigma", "sigma"),
        entry("K3", "K3 lq_fit (single pass)", lq_src,
              "picasso_tpu/ops/lq_pallas.py:25", "K3",
              stats["K3"]["xy_p100"], "plain_lq"),
        entry("K6", "K6 roi_lq_queue (one launch; phases 16/50/100 on "
              "the TPU)", "picasso_torch/csrc/roi_lq_queue.cu",
              "picasso_tpu/ops/lq_pallas.py:93", "K6",
              stats["K6"]["xy_p100"], "plain_lq"),
        entry("K1", "K1 roi_mle_fit sigmaxy (work queue, cooperative "
              "tail, CRLB/LL in the kernel)", fit_src,
              "picasso_tpu/ops/mle_pallas.py:36", "K1",
              stats["K1"]["xy_max_all"], "plain_fit", "sigmaxy"),
        entry("K1 sigma", "K1 roi_mle_fit sigma (work queue, cooperative "
              "tail, CRLB/LL in the kernel)", fit_src,
              "picasso_tpu/ops/mle_pallas.py:36", "K1",
              stats["K1 sigma"]["xy_max_all"], "plain_fit sigma", "sigma"),
        entry("K7", "K7 roi_mle_fit sigmaxy (one launch; rounds of "
              f"{ROUND_IT} on the TPU)", fit_src,
              "picasso_tpu/ops/mle_pallas.py:511", "K7",
              stats["K7"]["xy_max_all"], "plain K7", "sigmaxy"),
        entry("K1 one pass", "K1 one pass mle_fit sigmaxy (one thread a "
              "spot)", mle_src, "picasso_tpu/ops/mle_pallas.py:36",
              "K1 one pass", stats["K1 one pass"]["xy_max_all"], "plain_fit",
              "sigmaxy"),
        entry("K1 one pass sigma", "K1 one pass mle_fit sigma (one thread "
              "a spot)", mle_src, "picasso_tpu/ops/mle_pallas.py:36",
              "K1 one pass", stats["K1 one pass sigma"]["xy_max_all"],
              "plain_fit sigma", "sigma"),
    ]
    any_tpu = {"mle": "picasso_tpu/ops/mle_pallas.py:36",
               "lq": "picasso_tpu/ops/lq_pallas.py:25"}
    any_src = "picasso_torch/csrc/mle_anybox_queue.cu"
    one_src = "picasso_torch/csrc/mle_anybox.cu"
    k4_src = "picasso_torch/csrc/identify_anybox.cu"
    kernels += [
        entry("mle anybox", f"mle_anybox_queue sigmaxy (any box, work queue, "
              f"stage, cooperative tail, CRLB/LL in the kernel; timed at box "
              f"{TIMED_BOX})", any_src, any_tpu["mle"], "mle anybox",
              errs_any["mle anybox"], "plain mle anybox", "sigmaxy"),
        entry("mle anybox sigma", f"mle_anybox_queue sigma (any box, work "
              f"queue, stage, cooperative tail, CRLB/LL in the kernel; timed "
              f"at box {TIMED_BOX})", any_src, any_tpu["mle"], "mle anybox",
              errs_any["mle anybox sigma"], "plain mle anybox sigma",
              "sigma"),
        entry("mle anybox one pass", f"mle_anybox sigmaxy (any box, one "
              f"thread a spot, CRLB/LL; timed at box {TIMED_BOX})", one_src,
              any_tpu["mle"], "mle anybox one pass",
              errs_any["mle anybox one pass"], "plain mle anybox one pass",
              "sigmaxy"),
        entry("mle anybox one pass sigma", f"mle_anybox sigma (any box, one "
              f"thread a spot, CRLB/LL; timed at box {TIMED_BOX})", one_src,
              any_tpu["mle"], "mle anybox one pass",
              errs_any["mle anybox one pass sigma"],
              "plain mle anybox one pass sigma", "sigma"),
        entry("lq anybox", f"lq_anybox_queue (any box, work queue, a "
              f"group of lanes a spot, stage; timed at box {TIMED_BOX})",
              "picasso_torch/csrc/lq_anybox_queue.cu", any_tpu["lq"],
              "lq anybox", errs_any["lq anybox"], "plain lq anybox"),
        entry("lq anybox one pass", f"lq_anybox (any box, one thread a "
              f"spot; timed at box {TIMED_BOX})",
              "picasso_torch/csrc/lq_anybox.cu", any_tpu["lq"],
              "lq anybox one pass", errs_any["lq anybox one pass"],
              "plain lq anybox one pass"),
        entry("cut anybox", f"cut_anybox (K5's window load and photons at "
              f"any box, a tile of hits through shared memory; timed at box "
              f"{TIMED_BOX})", "picasso_torch/csrc/cut_anybox.cu",
              "picasso_tpu/ops/winfit_pallas.py:78", "cut anybox",
              errs_any["cut anybox"], "plain cut anybox"),
        entry("cut anybox direct", f"cut_anybox_direct (K5's window load "
              f"and photons at any box, one thread a pixel; timed at box "
              f"{TIMED_BOX})", "picasso_torch/csrc/cut_anybox.cu",
              "picasso_tpu/ops/winfit_pallas.py:78", "cut anybox direct",
              errs_any["cut anybox direct"], "plain cut anybox direct"),
        entry("K4 anybox", f"K4 identify_anybox (any box, staged tile, "
              f"separable maxima, the net gradient at maxima; timed at box "
              f"{TIMED_BOX})", k4_src,
              "picasso_tpu/ops/identify_pallas.py:58", "K4 anybox",
              errs_any["K4 anybox"], "plain K4 anybox"),
        entry("K4 anybox direct", f"K4 identify_anybox_direct (any box, one "
              f"thread a pixel; timed at box {TIMED_BOX})", k4_src,
              "picasso_tpu/ops/identify_pallas.py:58", "K4 anybox direct",
              errs_any["K4 anybox direct"], "plain K4 anybox direct"),
    ]
    for name, key, plain in (
            ("K1 roi_mle_fit sigmaxy (", "K1 box 3", "K1 box 3"),
            ("K3 roi_lq_queue", "K3 queue box 3", "K3 queue box 3"),
            ("mle_anybox_queue sigmaxy", "mle anybox box 3", "K1 box 3"),
            ("lq_anybox_queue", "lq anybox box 3", "K3 queue box 3")):
        k = next(k for k in kernels if k["name"].startswith(name))
        k["box3_ms"] = ms[key]
        k["box3_plain_ms"] = ms["plain " + plain]
        k["box3_bound_ms"] = bounds[plain][0]
    # the any-box kernels at boxes 1 and 2 (phase 26 (c)): time, plain,
    # bound and the launches on the paths of that box
    for name, key, method in (
            ("mle_anybox_queue sigmaxy (", "mle anybox", "sigmaxy"),
            ("mle_anybox_queue sigma (", "mle anybox sigma", "sigma"),
            ("mle_anybox sigmaxy (", "mle anybox one pass", "sigmaxy"),
            ("mle_anybox sigma (", "mle anybox one pass sigma", "sigma"),
            ("lq_anybox_queue (", "lq anybox", None),
            ("lq_anybox (", "lq anybox one pass", None),
            ("cut_anybox (", "cut anybox", None),
            ("cut_anybox_direct (", "cut anybox direct", None)):
        k = next(k for k in kernels if k["name"].startswith(name))
        # both methods count on one counter; the first forms on none of
        # these paths
        counter = "mle anybox" if key == "mle anybox sigma" else key
        for box in SMALL_BOXES:
            tag = f"box{box}"
            k[f"{tag}_launches"] = sum(
                v.get(counter, 0) for p, v in paths.items()
                if p.startswith(tag + "-") and (
                    method is None
                    or p.endswith("-sigma") == (method == "sigma")))
            k[f"{tag}_ms"] = ms[f"{key} {tag}"]
            k[f"{tag}_plain_ms"] = ms[f"plain {key} {tag}"]
            k[f"{tag}_bound_ms"], k[f"{tag}_bound_by"] = \
                bounds[f"{key} {tag}"]
            k[f"{tag}_max_abs_err"] = errs_any[f"{key} {tag}"]
    for k in kernels:  # the LM kernel's time on chunk 0 too
        if k["name"].startswith("K5 winfit_lq"):
            k["chunk0_ms"] = ms["K5 lq queue chunk 0"]
            k["chunk0_bound_ms"] = chunk_bound[0]
    # the fit kernels of fit2D on its first 262,144-ROI block too
    for name, key, block_key in (
            ("K1 roi_mle_fit sigmaxy (", "K1 fit2D", "fit2D"),
            ("K1 roi_mle_fit sigma (", "K1 fit2D sigma", "fit2D sigma"),
            ("K2 mle_fit sigmaxy (", "K2 fit2D", "fit2D"),
            ("K2 mle_fit sigma (", "K2 fit2D sigma", "fit2D sigma"),
            ("K3 roi_lq_queue", "K3 queue fit2D", "fit2D lq"),
            ("K3 lq_fit (single", "K3 fit2D", "fit2D lq"),
            ("K6 roi_lq_queue", "K6 fit2D", "fit2D lq")):
        k = next(k for k in kernels if k["name"].startswith(name))
        k["fit2d_block_ms"] = ms[key]
        k["fit2d_block_bound_ms"] = bounds[block_key][0]
        k["fit2d_block_plain_ms"] = ms["plain " + block_key]
    kernels.append(rec_entry)
    print(f"smoke: {time.perf_counter() - t_start:.1f} s after the start")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
