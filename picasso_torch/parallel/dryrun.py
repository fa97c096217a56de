"""The multi-device dry run: every sharded stage of parallel/mesh.py on
tiny shapes, checked together.

Counterpart of __graft_entry__.dryrun_multichip (:32-205), with the same
nine stages and checks, on the port: ``python -c "from
picasso_torch.parallel.dryrun import dryrun_multichip;
dryrun_multichip(4, devices=['cpu'] * 4)"`` on the CPU, or
``dryrun_multichip(torch.cuda.device_count())`` over every card. JAX's
stage "the Pallas cores agree with the XLA cores" is here "K5 agrees with
its plain version": the fused chain over the mesh against the same chain
with every shard on the CPU (on the CPU, the plain versions against
themselves).
"""

from __future__ import annotations

import numpy as np


#: K5's LM fit against its plain version on the dry run's Gaussian
#: spots (:func:`spot_frames`): x/y within LQ_XY px, photons/bg/sx/sy
#: within LQ_REL relative. JAX holds its Pallas cores to its XLA cores,
#: the same arithmetic, within 1e-5. The kernel sums in another order and
#: with expf, and the LM stops where its cost moves by less than 1e-6
#: relative, so rounding moves the stopping step: on the card (H100) 32
#: and 64 such spots were 5.74e-5 and 5.64e-5 px, 2.73e-4 and 2.85e-3
#: relative apart, and a 1e-6 relative change of the input moves the
#: plain fits about as far (tests/test_torch_parallel.py
#: test_dryrun_lq_bounds_are_the_rounding_floor).
LQ_XY, LQ_REL = 1e-4, 5e-3
#: the fitted positions against the spots drawn (px): Poisson noise of
#: 1500-3000 photons moves them by ~0.05 px
TRUTH_XY = 0.25
SPOT_CENTRES = ((8, 8), (8, 23), (23, 8), (23, 23))


def spot_frames(rng, n_frames: int, size: int = 32, bg: float = 20.0):
    """(n_frames, size, size) u16 Poisson frames, each with the four
    integrated Gaussian spots of SPOT_CENTRES, moved by up to 0.5 px,
    widths 1.0-1.3 px, 1500-3000 photons, over ``bg`` photons a pixel;
    and the (n_frames * 4, 3) truth (frame, y, x)."""
    from scipy.special import erf

    edges = np.arange(size + 1, dtype=np.float64) - 0.5
    frames, truth = [], []
    for f in range(n_frames):
        img = np.full((size, size), bg)
        for cy, cx in SPOT_CENTRES:
            y0, x0 = cy + rng.uniform(-0.5, 0.5), cx + rng.uniform(-0.5, 0.5)
            s, photons = rng.uniform(1.0, 1.3), rng.uniform(1500.0, 3000.0)
            gx = np.diff(0.5 * erf((edges - x0) / (np.sqrt(2) * s)))
            gy = np.diff(0.5 * erf((edges - y0) / (np.sqrt(2) * s)))
            img += photons * gy[:, None] * gx[None, :]
            truth.append((f, y0, x0))
        frames.append(rng.poisson(img))
    return np.asarray(frames, np.uint16), np.asarray(truth)


def lq_gaps(theta: np.ndarray, plain: np.ndarray) -> tuple[float, float]:
    """The largest x/y gap (px) and relative photons/bg/sx/sy gap of
    (N, 6) LM fits [x, y, photons, bg, sx, sy]."""
    d = np.abs(theta.astype(np.float64) - plain)
    rel = d[:, 2:] / np.abs(plain[:, 2:])
    return float(d[:, :2].max(initial=0)), float(rel.max(initial=0))


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """Run the sharded pipeline step, the sharded MLE and LM fits, the
    summed histogram, the pair correlations, identify, the fused chain
    (checked against its plain version), SPINNA scoring and the G5M EM
    over a mesh of ``n_devices`` shards: the first ``n_devices`` of
    ``devices``, by default of every visible card. Raises on any failed
    check; returns the summary line it prints."""
    from picasso_torch import spinna
    from picasso_torch.ops import gmm
    from picasso_torch.parallel.mesh import (
        Mesh, default_mesh, fit_g5m_clusters_sharded, fit_lq_sharded,
        fit_mle_sharded, identify_sharded, localize_fused_sharded,
        pair_xcorrs_sharded, render_hist_sharded, sharded_pipeline_step,
        spinna_score_sharded,
    )

    devices = list(default_mesh(devices).devices)[:n_devices]
    assert len(devices) == n_devices, (
        f"need {n_devices} devices, found {len(devices)}")
    mesh = Mesh(devices)

    rng = np.random.default_rng(0)
    # a tiny movie: one 32 x 32 frame a shard
    frames = rng.poisson(50.0, size=(n_devices, 32, 32)).astype(np.float32)
    theta, img = sharded_pipeline_step(frames, box=7, max_it=5, mesh=mesh)
    assert theta.shape[1] == 6
    assert np.isfinite(img).all()

    spots = rng.poisson(100.0, size=(8 * n_devices, 7, 7)).astype(np.float32)
    t, c, ll, it = fit_mle_sharded(spots, max_it=5, mesh=mesh)
    assert t.shape == (8 * n_devices, 6)
    assert np.isfinite(t).all()

    # the spot-sharded LM fit, the summed histogram, the pair-sharded RCC
    # correlations
    t_lq = fit_lq_sharded(spots, max_it=5, mesh=mesh)
    assert t_lq.shape == (8 * n_devices, 6)
    assert np.isfinite(t_lq).all()

    x = rng.uniform(0, 16, 64 * n_devices)
    y = rng.uniform(0, 16, 64 * n_devices)
    img_h = render_hist_sharded(x, y, (16, 16), mesh=mesh)
    assert img_h.shape == (16, 16)
    assert img_h.sum() == 64 * n_devices

    segs = rng.poisson(5.0, size=(4, 16, 16)).astype(np.float32)
    ii, jj = np.triu_indices(4, k=1)
    maps = pair_xcorrs_sharded(segs, ii, jj, mesh=mesh)
    assert maps.shape == (len(ii), 16, 16)
    assert np.isfinite(maps).all()

    # two frames a shard of four well-posed Gaussian spots each
    frames, truth = spot_frames(rng, 2 * n_devices)
    f_id, y_id, x_id, ng_id = identify_sharded(frames, 300.0, 5, mesh=mesh)
    assert len(f_id) == len(truth), (len(f_id), len(truth))

    # the fused identify + cut + fit chain, frame-sharded, and K5 against
    # its plain version (every shard on the CPU)
    cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1}
    f_fu, y_fu, x_fu, _, theta_fu, _, _, _ = localize_fused_sharded(
        frames, 300.0, 5, cam, mesh=mesh, bucket=512, method="lq",
        max_it=20)
    np.testing.assert_array_equal(f_fu, f_id)
    assert theta_fu.shape == (len(f_fu), 6)
    assert np.isfinite(theta_fu).all()
    fit = np.stack([f_fu, y_fu + theta_fu[:, 1], x_fu + theta_fu[:, 0]], 1)
    miss = np.abs(fit[:, None] - truth[None]).max(axis=2).min(axis=1)
    assert miss.max() <= TRUTH_XY, miss.max()
    f_pl, _, _, _, theta_pl, _, _, _ = localize_fused_sharded(
        frames, 300.0, 5, cam, mesh=Mesh(["cpu"] * n_devices), bucket=512,
        method="lq", max_it=20)
    np.testing.assert_array_equal(f_pl, f_fu)
    gap_xy, gap_rel = lq_gaps(theta_fu, theta_pl)
    assert gap_xy <= LQ_XY and gap_rel <= LQ_REL, (gap_xy, gap_rel)

    # the L5 batch workloads over the candidate and cluster axes
    mono = spinna.Structure("monomer")
    mono.define_coordinates("A", [0.0], [0.0], [0.0])
    mixer = spinna.StructureMixer([mono], label_unc={"A": 2.0},
                                  le={"A": 0.9}, width=500.0, height=500.0)
    np.random.seed(0)
    gt = mixer.run_simulation([20])
    sp = spinna.SPINNA(mixer, gt, N_sim=1, device=mesh.devices[0])
    cand_rows = np.arange(4, 4 + 2 * n_devices,
                          dtype=np.int32).reshape(-1, 1)
    scorer = sp._get_batched_scorer(cand_rows)
    scores = spinna_score_sharded(scorer, cand_rows, seed=1, mesh=mesh)
    assert scores.shape == (2 * n_devices,)
    assert np.all((scores >= 0) & (scores <= 1))

    Xs = [np.concatenate([rng.normal((0, 0), 1.0, (10, 2)),
                          rng.normal((8, 8), 1.0, (10, 2))]).astype(np.float32)
          for _ in range(n_devices + 1)]
    lps = [np.full(len(x), 0.5, np.float32) for x in Xs]
    Xg, mg, lpg = gmm.pad_clusters(Xs, lps, 20)
    w, mns, cv, pc, lb, conv, valid, ok = fit_g5m_clusters_sharded(
        Xg, mg, lpg, K=2, sigma_bounds=(0.1, 10.0), isotropic=True,
        loc_local=False, n_init=1, min_locs=4, mesh=mesh)
    assert mns.shape == (n_devices + 1, 2, 2)
    assert np.isfinite(lb).all()

    line = (f"dryrun_multichip OK on {n_devices} devices "
            f"({len(set(mesh.devices))} distinct): "
            f"pipeline theta {theta.shape}, sharded MLE {t.shape}, "
            f"sharded LQ {t_lq.shape}, render sum {img_h.shape}, "
            f"pair xcorrs {maps.shape}, sharded identify {len(f_id)} hits, "
            f"sharded fused localize {theta_fu.shape} "
            f"(K5 and its plain version within {gap_xy:.3g} px and "
            f"{gap_rel:.3g} relative), "
            f"sharded SPINNA scoring {scores.shape}, "
            f"sharded g5m EM {mns.shape}")
    print(line)
    return line
