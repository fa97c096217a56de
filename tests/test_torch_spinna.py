"""SPINNA of the port held against picasso_tpu on the CPU: the search
space, structures, masks, the host simulation and scorer, the batched
scorer's kNN, KS and scores, the Gaussian process of fit_bayesian, the
fit modes, model comparison and LE fitting, the batch analysis, the
verbs, and the device rule of the entry points.

Tolerances, with what was measured on the CPU (numpy 2, scipy 1.17,
sklearn 1.9, torch 2.13, jax 0.9):
- exact: the search spaces, target counts, permutations, proportions,
  masks (2D, 3D, thresholded) and the structures' YAML; rref within
  RREF_ABS of JAX's (its own pivoting; measured 0 on the search spaces);
- bit for bit under one np.random.seed: run_simulation (CSR, mask, 3D),
  get_NN_dist, NND_score, _evaluate_single, the fits that take the host
  route (fewer than BATCH_MIN_CANDIDATES candidates), fit_bayesian
  (n_initial 3: every score from the host scorer), compare_models and
  fit_le at 3 candidates;
- knn_masked within KNN_ULPS f32 ulps of jax.vmap(knn_masked) (JAX may
  round d^2 with an FMA; measured 1), the same +inf entries;
  ks_2samp_masked equal to scipy.stats.ks_2samp (exact and asymptotic
  modes, ties) and within KS_JAX of JAX's, which forms the statistic in
  f32 (JAX's own test holds it to scipy within 1e-6);
- score_coords within KS_JAX of JAX's knn_masked + ks_2samp_masked and
  its averaging on the same simulated coordinates;
- the batched scores against JAX's serial ones as JAX holds its own
  (tests/test_spinna_batch.py): max |diff| < 0.06, corr > 0.98, argmin
  within 1; recovery of a 60 % mixture within 12 points;
- the GP: length scale, mean and std within GP_REL of sklearn's (measured
  0: the same scipy calls in the same order), the same EI argmax.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import ks_2samp

import jax
import jax.numpy as jnp

from picasso_torch import spinna as ts
from picasso_torch.ops import neighbors as tn
from picasso_torch.ops import spinna_batch as tb
from picasso_tpu import spinna as js
from picasso_tpu.ops import neighbors as jn

RREF_ABS = 1e-12
KNN_ULPS = 1
KS_JAX = 2e-6
GP_REL = 1e-6
CPU = {"device": "cpu"}


def _structures(mod, kinds, target="A"):
    out = []
    for kind in kinds:
        s = mod.Structure(kind)
        if kind == "monomer":
            s.define_coordinates(target, [0.0], [0.0], [0.0])
        elif kind == "dimer":
            s.define_coordinates(target, [-10.0, 10.0], [0.0, 0.0],
                                 [0.0, 0.0])
        elif kind == "trimer":
            h = 10 * np.sqrt(3)
            s.define_coordinates(target, [-10.0, 10.0, 0.0],
                                 [-h / 3, -h / 3, 2 * h / 3],
                                 [0.0, 0.0, 0.0])
        elif kind == "A-only":
            s.define_coordinates("A", [0.0], [0.0])
        elif kind == "B-only":
            s.define_coordinates("B", [0.0], [0.0])
        elif kind == "AB":
            s.define_coordinates("A", [0.0], [0.0])
            s.define_coordinates("B", [15.0], [0.0])
        elif kind == "AAB":
            s.define_coordinates("A", [0.0, 12.0], [0.0, 5.0])
            s.define_coordinates("B", [20.0], [3.0])
        out.append(s)
    return out


SPACES = [
    (("monomer", "dimer"), {"A": 1000}, 11),
    (("monomer", "dimer", "trimer"), {"A": 5000}, 21),
    (("A-only", "AB"), {"A": 60, "B": 30}, 10),
    (("A-only", "B-only", "AB"), {"A": 300, "B": 200}, 7),
    (("AB", "A-only", "B-only", "AAB"), {"A": 400, "B": 150}, 6),
    (("A-only", "AB"), {"A": 50, "B": 20}, 99),
]


def _mixer(mod, kinds=("monomer", "dimer"), le=0.9, unc=2.0, **kw):
    kw.setdefault("width", 3000.0)
    kw.setdefault("height", 3000.0)
    return mod.StructureMixer(list(_structures(mod, kinds)),
                              label_unc={"A": unc}, le={"A": le}, **kw)


def _pair(kinds=("monomer", "dimer"), counts=(200, 300), seed=0, **kw):
    """The same mixer in both packages and its ground truth, drawn under
    one seed (equal bit for bit)."""
    out = []
    for mod in (js, ts):
        mixer = _mixer(mod, kinds, **kw)
        np.random.seed(seed)
        out.append((mixer, mixer.run_simulation(list(counts))))
    for t in out[0][1]:
        np.testing.assert_array_equal(out[0][1][t], out[1][1][t])
    return out


# ---------------------------------------------------------------------------
# exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kinds,N_total,granularity", SPACES)
def test_search_space_matches_jax(kinds, N_total, granularity, tmp_path):
    """rref of the augmented system, the target counts, the permutation
    and the search space itself; its CSV reads back as JAX's."""
    js_s, ts_s = (_structures(m, kinds) for m in (js, ts))
    targets = ts._targets_from_structures(ts_s)
    assert targets == js._targets_from_structures(js_s)
    tc = ts.find_target_counts(targets, ts_s)
    np.testing.assert_array_equal(tc, js.find_target_counts(targets, js_s))
    assert tc.dtype == np.float32
    if len(kinds) > len(targets):
        np.testing.assert_array_equal(ts.get_structures_permutation(tc),
                                      js.get_structures_permutation(tc))
    aug = np.hstack((tc, np.array([[N_total[t]] for t in targets])))
    np.testing.assert_allclose(ts.rref(aug), js.rref(aug), rtol=0,
                               atol=RREF_ABS)
    paths = [str(tmp_path / f"{n}.csv") for n in ("t", "j")]
    got = ts.generate_N_structures(ts_s, N_total, granularity, save=paths[0])
    ref = js.generate_N_structures(js_s, N_total, granularity, save=paths[1])
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
        assert got[k].dtype == ref[k].dtype
    a, b = pd.read_csv(paths[0]), pd.read_csv(paths[1])
    pd.testing.assert_frame_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_rref_matches_jax_on_general_matrices(seed):
    """Full-rank, rank-deficient and wide matrices: the same reduced row
    echelon form (it is unique) within RREF_ABS."""
    rng = np.random.default_rng(seed)
    mats = [rng.normal(0, 1, (3, 3)) + 3 * np.eye(3),
            rng.integers(0, 4, (3, 5)).astype(float),
            np.array([[2.0, 4.0, 1.0], [1.0, 2.0, 0.5], [0.0, 1.0, 3.0]])]
    for M in mats:
        np.testing.assert_allclose(ts.rref(M), js.rref(M), rtol=0,
                                   atol=RREF_ABS)


def test_counts_and_props_conversions_match_jax():
    rows = np.array([[40, 30], [0, 50], [100, 0], [7, 3], [0, 0]])
    for kinds in (("monomer", "dimer"), ("monomer", "dimer", "trimer")):
        mj, mt = _mixer(js, kinds), _mixer(ts, kinds)
        r = rows if len(kinds) == 2 else np.column_stack([rows, rows[:, 0]])
        for x in (r, r[1], {s: r[:, i] for i, s in enumerate(kinds)}):
            a, b = mt.convert_counts_to_props(x), mj.convert_counts_to_props(x)
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(
                mt.convert_N_structures_to_array(x),
                mj.convert_N_structures_to_array(x))
        props = mj.convert_counts_to_props(r)
        np.testing.assert_array_equal(mt.convert_props_to_counts(props, 500),
                                      mj.convert_props_to_counts(props, 500))
        assert mt.get_neighbor_idx(True) == mj.get_neighbor_idx(True)
        assert mt.get_metadata() == mj.get_metadata()


def _mask_locs(rng, n=3000, z=False):
    fields = [("frame", np.uint32), ("x", np.float32), ("y", np.float32)]
    if z:
        fields.append(("z", np.float32))
    locs = np.zeros(n, fields)
    locs["frame"] = rng.integers(0, 100, n)
    locs["x"] = rng.uniform(2, 30, n)
    locs["y"] = rng.uniform(2, 20, n)
    if z:
        locs["z"] = rng.normal(0, 150, n)
    return locs


@pytest.mark.parametrize("mode", ["2D", "3D"])
@pytest.mark.parametrize("thresholded", [False, True])
def test_mask_generator_matches_jax(mode, thresholded, tmp_path):
    locs = _mask_locs(np.random.default_rng(4), z=mode == "3D")
    info = [{"Frames": 100, "Height": 32, "Width": 32, "Pixelsize": 130}]
    gt = ts.MaskGenerator(locs, info, binsize=130.0, sigma=260.0, mode=mode)
    gj = js.MaskGenerator(pd.DataFrame(locs), info, binsize=130.0,
                          sigma=260.0, mode=mode)
    a, b = gt.generate_mask(thresholded), gj.generate_mask(thresholded)
    np.testing.assert_array_equal(a, b)
    assert a.ndim == (3 if mode == "3D" else 2)
    assert (gt.area, gt.volume) == (gj.area, gj.volume)
    assert gt.mask_info()["Shape"] == gj.mask_info()["Shape"]
    gt.save_mask(str(tmp_path / "m.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"), a)
    assert js.io.load_info(str(tmp_path / "m.yaml"))[0]["Mode"] == mode


def test_structures_yaml_round_trip_matches_jax(tmp_path):
    """Saved by one package, loaded by the other: the same titles,
    targets and coordinates."""
    for save_mod, load_mod in ((ts, js), (js, ts)):
        structs = _structures(save_mod, ("trimer", "AB"))
        path = str(tmp_path / f"{save_mod.__name__}.yaml")
        save_mod.io.save_info(path, [s.get_info() for s in structs])
        loaded, targets = load_mod.load_structures(path)
        ref, ref_t = save_mod.load_structures(path)
        assert targets == ref_t == ["A", "B"]
        for a, b in zip(loaded, ref):
            assert a.get_info() == b.get_info() and repr(a) == repr(b)
    with pytest.raises(ValueError, match="yaml"):
        _structures(ts, ("dimer",))[0].save(str(tmp_path / "s.txt"))


def test_coords_to_locs_and_rotations_match_jax():
    rng = np.random.default_rng(1)
    for dim in (2, 3):
        c = rng.uniform(0, 2000, (50, dim))
        a, b = ts.coords_to_locs(c, lp=13.0), js.coords_to_locs(c, lp=13.0)
        assert list(a.dtype.names) == list(b.columns)
        for n in a.dtype.names:
            np.testing.assert_array_equal(a[n], b[n].to_numpy())
            assert a[n].dtype == b[n].dtype
    for mode in ("2D", "3D", None):
        np.random.seed(3)
        a = ts.random_rotation_matrices(16, mode)
        np.random.seed(3)
        np.testing.assert_array_equal(a, js.random_rotation_matrices(16, mode))
    with pytest.raises(ValueError):
        ts.random_rotation_matrices(4, "4D")


# ---------------------------------------------------------------------------
# bit for bit under np.random.seed
# ---------------------------------------------------------------------------


def _mask_dict():
    mask = np.zeros((10, 12))
    mask[2:5, 5:9] = 1.0
    mask[7, 1] = 3.0
    mask /= mask.sum()
    return {"masks": {"A": mask}, "infos": {"A": {"Binsize (nm)": 100.0,
                                                 "Shape": [10, 12]}}}


@pytest.mark.parametrize("case", ["csr", "mask", "3d", "none"])
def test_run_simulation_matches_jax(case):
    kw = {"csr": {}, "mask": {"mask_dict": _mask_dict(), "width": None,
                              "height": None},
          "3d": {"depth": 500.0, "random_rot_mode": "3D"},
          "none": {"random_rot_mode": None}}[case]
    (mj, gj), (mt, gt) = _pair(("monomer", "dimer", "trimer"),
                               (120, 80, 40), seed=11, le=0.7, unc=4.0, **kw)
    for t in gj:
        assert gj[t].shape == gt[t].shape and gj[t].shape[0] > 0
    for sj, st in zip(mj.simulators, mt.simulators):
        np.testing.assert_array_equal(sj.c_pos, st.c_pos)


def test_nn_dist_and_score_match_jax():
    (mj, gj), (mt, gt) = _pair(seed=2)
    dj = js.get_NN_dist_experimental(gj, mj, duplicate=True)
    dt = ts.get_NN_dist_experimental(gt, mt, duplicate=True)
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a, b)
    np.random.seed(3)
    sj = js.get_NN_dist_simulated([150, 200], 3, mj)
    np.random.seed(3)
    st = ts.get_NN_dist_simulated([150, 200], 3, mt)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)
    assert ts.NND_score(st, dt) == js.NND_score(sj, dj)
    assert ts.NND_score([np.array([])], [np.ones((3, 1))]) == 1.0
    assert len(ts.get_NN_dist(np.zeros((0, 2)), np.zeros((5, 2)), 1)) == 0
    with pytest.raises(ValueError):
        ts.get_NN_dist(np.zeros((5, 2)), np.zeros((5, 3)), 1)


@pytest.mark.parametrize("kw", [{}, {"depth": 400.0,
                                      "random_rot_mode": "3D"}])
def test_evaluate_single_matches_jax(kw):
    (mj, gj), (mt, gt) = _pair(seed=5, **kw)
    spj = js.SPINNA(mj, gj, N_sim=2)
    spt = ts.SPINNA(mt, gt, N_sim=2, **CPU)
    for row in ([200, 300], [500, 50], [0, 400]):
        np.random.seed(6)
        a = spt._evaluate_single(np.array(row))
        np.random.seed(6)
        assert a == spj._evaluate_single(np.array(row))


# ---------------------------------------------------------------------------
# knn_masked and ks_2samp_masked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("k,block", [(1, 128), (3, 128), (2, 2000)])
def test_knn_masked_matches_jax(exclude_self, k, block):
    rng = np.random.default_rng(k)
    R, N, M = 3, 500, 700
    a = rng.uniform(0, 3000, (R, N, 2)).astype(np.float32)
    am = rng.random((R, N)) < 0.9
    if exclude_self:
        b, bm = a, am
    else:
        b = rng.uniform(0, 3000, (R, M, 2)).astype(np.float32)
        bm = rng.random((R, M)) < 0.8
        bm[2] = False  # an empty b
    ref = np.asarray(jax.vmap(lambda x, y, xm, ym: jn.knn_masked(
        x, y, xm, ym, k, exclude_self=exclude_self, b_block=min(block, M)))(
        a, b, am, bm))
    got = tn.knn_masked(*(torch.from_numpy(v) for v in (a, b, am, bm)), k,
                        exclude_self=exclude_self, b_block=block).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    ulps = np.abs(ref[fin].view(np.int32).astype(np.int64)
                  - got[fin].view(np.int32).astype(np.int64))
    assert ulps.max() <= KNN_ULPS


def test_ks_2samp_masked_matches_scipy_and_jax():
    rng = np.random.default_rng(3)
    gt = np.sort(rng.exponential(12, 333).astype(np.float32))
    cases = [(rng.exponential(10, 400), gt), (rng.normal(8, 3, 400), gt),
             (np.round(rng.exponential(10, 400) * 0.3),  # ties
              np.round(gt * 0.3)),
             (rng.integers(0, 6, 300), np.sort(rng.integers(0, 6, 200))),
             (gt[::-1], gt),  # the same sample: 0
             (rng.exponential(11, 12000), gt)]  # scipy's asymptotic mode
    for s, g in cases:
        s, g = s.astype(np.float32), g.astype(np.float32)
        mask = np.ones((2, len(s)), bool)
        mask[1, len(s) // 3:] = False
        S = np.stack([s, s])
        got = tn.ks_2samp_masked(torch.from_numpy(S), torch.from_numpy(mask),
                                 torch.from_numpy(g)).numpy()
        for i in range(2):
            assert got[i] == ks_2samp(S[i][mask[i]], g).statistic
            ref = float(jn.ks_2samp_masked(jnp.asarray(S[i]),
                                           jnp.asarray(mask[i]),
                                           jnp.asarray(g)))
            assert abs(got[i] - ref) <= KS_JAX
    pad = np.concatenate([cases[0][0], np.full(50, np.inf)]).astype(
        np.float32)
    got = tn.ks_2samp_masked(torch.from_numpy(pad[None]),
                             torch.ones((1, len(pad)), dtype=torch.bool),
                             torch.from_numpy(gt))
    assert got.item() == ks_2samp(pad[:400], gt).statistic
    empty = tn.ks_2samp_masked(torch.zeros((1, 10)),
                               torch.zeros((1, 10), dtype=torch.bool),
                               torch.from_numpy(gt))
    assert empty.item() == 1.0


def _jax_scores(scorer, coords, masks):
    """JAX's kNN, KS and averaging (picasso_tpu/ops/spinna_batch.py
    :372-414) on the port's simulated coordinates."""
    B = next(iter(masks.values())).shape[0] // scorer.N_sim
    knn, eff = [], []
    for i1, i2, n in scorer.pair_keys:
        t1, t2 = scorer.targets[i1], scorer.targets[i2]
        c1, m1 = coords[t1].numpy(), masks[t1].numpy()
        c2, m2 = coords[t2].numpy(), masks[t2].numpy()
        d = jax.vmap(lambda a, b, am, bm: jn.knn_masked(
            a, b, am, bm, n, exclude_self=(t1 == t2),
            b_block=min(512, c2.shape[1])))(c1, c2, m1, m2)
        e = m1 & (m2.sum(1) > 0)[:, None]
        knn.append(np.asarray(d).reshape(B, -1, n))
        eff.append(e.reshape(B, -1))
    total, n_scored = np.zeros(B), np.zeros(B)
    for pk, j, gt_sorted in scorer.pairs:
        g = jnp.asarray(gt_sorted.numpy())
        stat = np.array([float(jn.ks_2samp_masked(
            jnp.asarray(knn[pk][b, :, j]), jnp.asarray(eff[pk][b]), g))
            for b in range(B)])
        ok = eff[pk].sum(1) > 0
        total += np.where(ok, stat, 0.0)
        n_scored += ok
    return np.where(n_scored > 0, total / np.maximum(n_scored, 1), 1.0)


@pytest.mark.parametrize("kinds", [("monomer", "dimer"),
                                   ("A-only", "AB")])
def test_score_coords_matches_jax(kinds):
    mixer = ts.StructureMixer(_structures(ts, kinds), label_unc={"ALL": 2.0},
                              le={"ALL": 0.8}, width=2000.0, height=2000.0)
    np.random.seed(1)
    gt = mixer.run_simulation([150, 100])
    sp = ts.SPINNA(mixer, gt, N_sim=2, **CPU)
    rows = np.array([[150, 100], [300, 0], [0, 180], [0, 0]])
    scorer = sp._get_batched_scorer(rows)
    coords, masks = scorer.simulate(rows, seed=3)
    got = scorer.score_coords(coords, masks).numpy()
    np.testing.assert_allclose(got, _jax_scores(scorer, coords, masks),
                               rtol=0, atol=KS_JAX)
    assert got[3] == 1.0


# ---------------------------------------------------------------------------
# the batched scorer, statistically (as tests/test_spinna_batch.py)
# ---------------------------------------------------------------------------


def test_batched_scores_match_jax_serial():
    (mj, gj), (mt, gt) = _pair(counts=(200, 400), seed=1)
    spj = js.SPINNA(mj, gj, N_sim=8)
    spt = ts.SPINNA(mt, gt, N_sim=8, **CPU)
    rows = mt.convert_N_structures_to_array(
        ts.generate_N_structures(mt.structures, {"A": 1000}, granularity=9))
    np.random.seed(2)
    batched = spt._get_batched_scorer(rows).score(rows, seed=7)
    serial = np.array([spj._evaluate_single(r) for r in rows])
    assert np.max(np.abs(batched - serial)) < 0.06
    assert np.corrcoef(batched, serial)[0, 1] > 0.98
    assert abs(int(np.argmin(batched)) - int(np.argmin(serial))) <= 1


def test_batched_draws_do_not_depend_on_the_chunk():
    """Keyed by candidate index: chunks of 1, 2 and all give the same
    scores bit for bit, and another seed others."""
    _, (mt, gt) = _pair(seed=4)
    sp = ts.SPINNA(mt, gt, N_sim=2, **CPU)
    rows = np.array([[200, 300], [400, 200], [0, 450], [600, 100], [50, 0]])
    scorer = sp._get_batched_scorer(rows)
    ref = scorer.score(rows, seed=9)
    for chunk in (1, 2):
        scorer.chunk = chunk
        np.testing.assert_array_equal(scorer.score(rows, seed=9), ref)
    assert not np.array_equal(scorer.score(rows, seed=10), ref)
    sub = scorer.score(rows[2:], seed=9)  # candidate 0 of this call
    assert not np.array_equal(sub, ref[2:])


def test_fit_recovers_mixture_through_batched_path():
    _, (mt, gt) = _pair(counts=(600, 200), seed=3)
    sp = ts.SPINNA(mt, gt, N_sim=8, **CPU)
    grid = ts.generate_N_structures(mt.structures, {"A": 1000},
                                    granularity=11)
    np.random.seed(4)
    props, score = sp.fit(grid, fitting_mode="brute-force")
    assert props[0] == pytest.approx(60.0, abs=12.0)
    assert score < 0.15


def test_le_thinning_exact_counts():
    _, (mt, gt) = _pair(seed=8, le=0.7)
    sp = ts.SPINNA(mt, gt, N_sim=1, **CPU)
    rows = np.array([[64, 32], [10, 5], [0, 3], [3, 0]])
    scorer = sp._get_batched_scorer(rows)
    counts = torch.from_numpy(rows[:, 1])
    cand = torch.arange(4)
    _, keep = scorer._simulate_structure(1, counts, cand, cand * 0, 0)["A"]
    # floor(n_valid * le) in f32, as JAX forms it
    expected = np.floor((rows[:, 1] * 2).astype(np.float32)
                        * np.float32(0.7)).astype(int)
    np.testing.assert_array_equal(keep.sum(1).numpy(), expected)


def test_mask_placement_stays_on_support():
    mask = np.zeros((10, 10), np.float32)
    mask[2:4, 5:9] = 1.0
    mask /= mask.sum()
    mixer = ts.StructureMixer(
        _structures(ts, ("monomer",)), label_unc={"A": 0.0}, le={"A": 1.0},
        mask_dict={"masks": {"A": mask},
                   "infos": {"A": {"Binsize (nm)": 100.0}}})
    gt = {"A": np.random.default_rng(0).uniform(0, 1000, (50, 2))}
    sp = ts.SPINNA(mixer, gt, N_sim=1, **CPU)
    rows = np.array([[500], [300], [20], [1]])
    coords, masks = sp._get_batched_scorer(rows).simulate(rows, seed=1)
    pts = coords["A"][masks["A"]].numpy()
    assert len(pts) == 821
    # the mask's support is x in [500, 900), y in [200, 400)
    assert (pts[:, 0] >= 500).all() and (pts[:, 0] <= 900).all()
    assert (pts[:, 1] >= 200).all() and (pts[:, 1] <= 400).all()


def test_empty_candidate_scores_one():
    _, (mt, gt) = _pair(counts=(50, 50), seed=14)
    sp = ts.SPINNA(mt, gt, N_sim=1, **CPU)
    rows = np.array([[0, 0], [50, 50], [0, 1], [1, 0]])
    scores = sp._get_batched_scorer(rows).score(rows, seed=15)
    assert scores[0] == 1.0 and scores[1] < 1.0


def test_3d_mixer_scores():
    kw = {"depth": 800.0, "random_rot_mode": "3D"}
    (mj, gj), (mt, gt) = _pair(counts=(150, 150), seed=9, **kw)
    spj = js.SPINNA(mj, gj, N_sim=4)
    spt = ts.SPINNA(mt, gt, N_sim=4, **CPU)
    rows = np.array([[150, 150], [300, 75], [0, 225], [225, 38]])
    np.random.seed(10)
    batched = spt._get_batched_scorer(rows).score(rows, seed=11)
    serial = np.array([spj._evaluate_single(r) for r in rows])
    assert np.all(np.abs(batched - serial) < 0.08)
    assert int(np.argmin(batched)) == int(np.argmin(serial)) == 0


def test_rotations_are_rotations():
    keys = tb.row_keys(1, torch.arange(4), torch.zeros(4, dtype=torch.int64),
                       0, 0)
    for mode in ("2D", "3D"):
        R = tb._rotations(mode, lambda s: tb.row_keys(
            1, torch.arange(4), torch.zeros(4, dtype=torch.int64), 0, 8 + s),
            (4, 64)).double().numpy()
        np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2),
                                   np.broadcast_to(np.eye(3), R.shape),
                                   atol=1e-6)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-6)
    u = tb.uniform(keys, 100000).numpy()
    assert 0 < u.min() and u.max() < 1 and abs(u.mean() - 0.5) < 0.01
    z = tb.normal64(keys, tb.row_keys(2, torch.arange(4), torch.zeros(
        4, dtype=torch.int64), 0, 0), 100000).numpy()
    assert abs(z.mean()) < 0.01 and abs(z.std() - 1) < 0.01
    assert tb._bucket(1) == 8 and tb._bucket(9) == 16
    assert tb._bucket(1000) == 1024


# ---------------------------------------------------------------------------
# the Gaussian process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,seed", [(5, 2, 0), (20, 3, 1), (60, 2, 2),
                                      (30, 2, 3)])
def test_gp_matches_sklearn(n, d, seed):
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import Matern

    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, (n, d)).astype(np.float32)
    y = 0.1 + np.abs(X[:, 0] - 40) / 200 + rng.normal(0, 0.01, n)
    if seed == 3:
        X, y = X / 30, np.full(n, 0.2)  # std 0, close points
    Xq = rng.uniform(0, 100, (300, d)).astype(np.float32)
    ref = GaussianProcessRegressor(kernel=Matern(nu=2.5), normalize_y=True,
                                   alpha=1e-4).fit(X, y)
    mu, sd = ref.predict(Xq, return_std=True)
    gp = ts.MaternGP().fit(X, y)
    mu2, sd2 = gp.predict(Xq)
    np.testing.assert_allclose(gp.length_scale_, ref.kernel_.length_scale,
                               rtol=GP_REL)
    np.testing.assert_allclose(mu2, mu, rtol=GP_REL, atol=0)
    np.testing.assert_allclose(sd2, sd, rtol=GP_REL, atol=1e-12)
    assert np.argmax(ts.expected_improvement(mu2, sd2, y.min())) == np.argmax(
        ts.expected_improvement(mu, sd, y.min()))


def test_fit_bayesian_matches_jax():
    """25 candidates, n_initial 3 (the host route), 10 iterations: the
    same candidates visited, the same scores and result."""
    (mj, gj), (mt, gt) = _pair(counts=(300, 200), seed=3)
    out = []
    for mod, mixer, g, kw in ((js, mj, gj, {}), (ts, mt, gt, CPU)):
        sp = mod.SPINNA(mixer, g, N_sim=1, **kw)
        N = mod.generate_N_structures(mixer.structures, {"A": 700},
                                      granularity=25)
        np.random.seed(4)
        out.append(sp.fit_bayesian(N, n_initial=3, n_iterations=10,
                                   return_scores=True))
    (pj, sj, vj), (pt, st, vt) = out
    np.testing.assert_array_equal(pt, pj)
    assert st == sj and len(vt) == 13
    np.testing.assert_array_equal(vt, vj)


# ---------------------------------------------------------------------------
# the fit modes on the host route, model comparison, LE fitting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["brute-force", "coarse-to-fine"])
def test_host_route_fits_match_jax(mode, tmp_path, monkeypatch):
    """Three candidates (the host route): the same fit, scores CSV and
    bootstrap as JAX's, bit for bit."""
    monkeypatch.setattr(js, "N_BOOTSTRAPS", 2)
    monkeypatch.setattr(ts, "N_BOOTSTRAPS", 2)
    (mj, gj), (mt, gt) = _pair(counts=(60, 70), seed=0, width=5000.0,
                               height=5000.0)
    rows = np.array([[60, 70], [120, 40], [10, 95]])
    out = []
    for mod, mixer, g, kw, name in ((js, mj, gj, {}, "j"),
                                    (ts, mt, gt, CPU, "t")):
        sp = mod.SPINNA(mixer, g, N_sim=1, **kw)
        np.random.seed(5)
        res = sp.fit_stoichiometry(rows, fitting_mode=mode,
                                   save=str(tmp_path / f"{name}.csv"),
                                   return_scores=True, bootstrap=True,
                                   asynch=False)
        out.append(res)
    (a, b, sa), (c, d, sb) = out[0], out[1]
    for x, y in ((a[0], c[0]), (a[1], c[1]), (sa, sb)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert b == d
    text = [open(tmp_path / f"{n}.csv").read() for n in ("t", "j")]
    assert text[0] == text[1]
    assert text[0].startswith("N_monomer,N_dimer,Prop_monomer,Prop_dimer,"
                              "Kolmogorov-Smirnov statistic\n")


def test_batched_scorer_failure_raises(monkeypatch):
    """No fallback: a failure of the batched scorer reaches the caller,
    and no PICASSO_TPU_* variable is read."""
    _, (mt, gt) = _pair(seed=1)
    sp = ts.SPINNA(mt, gt, N_sim=1, **CPU)

    def fail(self, *a, **k):
        raise RuntimeError("scorer failed")

    monkeypatch.setattr(tb.BatchedScorer, "score", fail)
    with pytest.raises(RuntimeError, match="scorer failed"):
        sp.NN_scorer(np.array([[1, 1]] * 4))
    assert len(sp.NN_scorer(np.array([[1, 1]] * 3))[1]) == 3
    for mod in (ts, tb):
        assert "PICASSO_TPU" not in open(mod.__file__).read()


def test_bootstrap_through_batched_scorer(monkeypatch):
    monkeypatch.setattr(ts, "N_BOOTSTRAPS", 3)
    _, (mt, gt) = _pair(counts=(300, 100), seed=12)
    sp = ts.SPINNA(mt, gt, N_sim=2, **CPU)
    grid = ts.generate_N_structures(mt.structures, {"A": 500}, granularity=6)
    np.random.seed(13)
    (props, props_std), (score, score_std) = sp.fit(
        grid, fitting_mode="brute-force", bootstrap=True)
    assert np.all(np.isfinite(props_std)) and np.isfinite(score_std)
    rows = mt.convert_N_structures_to_array(grid)
    assert sp.fit_stoichiometry_parallel(rows)[0][1].shape == (6,)


def _le_data(seed=3):
    out = []
    for mod in (js, ts):
        np.random.seed(seed)
        m = mod.StructureMixer(_structures(mod, ("A-only", "B-only", "AB")),
                               label_unc={"ALL": 3.0}, le={"ALL": 1.0},
                               width=4000.0, height=4000.0)
        out.append(m.run_simulation([30, 30, 60]))
    return out


def test_compare_models_and_fit_le_match_jax():
    """Three candidates a model (granularity 3, the host route): the same
    winner, label uncertainty, score, proportions and LEs."""
    dj, dt = _le_data()
    res = []
    for mod, data, kw in ((js, dj, {}), (ts, dt, CPU)):
        np.random.seed(7)
        res.append(mod.fit_le("A", "B", data, 3, {"A": [2.0, 4.0],
                                                  "B": 3.0}, [10.0, 15.0],
                              width=4000.0, height=4000.0, **kw))
    (lj, uj, dj_, sj, pj, _), (lt, ut, dt_, st, pt, _) = res
    assert (lj, uj, dj_, sj) == (lt, ut, dt_, st)
    np.testing.assert_array_equal(pj, pt)
    models = [_structures(js, ("A-only", "B-only", "AB")),
              _structures(ts, ("A-only", "B-only", "AB"))]
    np.random.seed(8)
    roi = {"width": 4000.0, "height": 4000.0}
    a = js.compare_models_given_label_unc([models[0]], _le_data()[0], 3,
                                          {"A": [3.0, 5.0], "B": 3.0}, **roi)
    np.random.seed(8)
    b = ts.compare_models_given_label_unc([models[1]], _le_data()[1], 3,
                                          {"A": [3.0, 5.0], "B": 3.0}, **roi,
                                          **CPU)
    assert a[:3] == b[:3] and a[5][0]["score"] == b[5][0]["score"]
    np.testing.assert_array_equal(a[3], b[3])
    for props in ([25.0, 25.0, 50.0], [10.0, 60.0, 30.0]):
        assert ts.get_le_from_props(props, models[1], ["A", "B"]) == \
            js.get_le_from_props(props, models[0], ["A", "B"])
    for N_total in ({"A": 50, "B": 50}, {"A": 50}):
        for ms in (models, [m[2:] for m in models]):
            assert ts.check_structures_valid_for_fitting(ms[1], N_total) == \
                js.check_structures_valid_for_fitting(ms[0], N_total)


def test_plot_nn_draws_each_pair():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, (mt, gt) = _pair(seed=2)
    np.random.seed(1)
    dists = ts.get_NN_dist_experimental(gt, mt)
    fig = ts.plot_NN(dists, ts.get_NN_dist_simulated([200, 300], 1, mt), mt)
    assert len(fig.axes) == 1 and fig.axes[0].get_title() == "A -> A"
    plt.close(fig)


# ---------------------------------------------------------------------------
# batch analysis and the verbs
# ---------------------------------------------------------------------------

PIXELSIZE = 130.0


def _write_exp_locs(path, coords_nm, extra_info=None):
    from picasso_torch import io

    n = len(coords_nm)
    locs = np.zeros(n, [("frame", np.uint32), ("x", np.float32),
                        ("y", np.float32), ("photons", np.float32),
                        ("sx", np.float32), ("sy", np.float32),
                        ("bg", np.float32), ("lpx", np.float32),
                        ("lpy", np.float32)])
    locs["frame"] = np.arange(n) % 100
    locs["x"] = coords_nm[:, 0] / PIXELSIZE
    locs["y"] = coords_nm[:, 1] / PIXELSIZE
    locs["photons"], locs["sx"], locs["sy"] = 1000, 1.0, 1.0
    locs["bg"], locs["lpx"], locs["lpy"] = 10, 0.05, 0.05
    info = [{"Frames": 100, "Height": 64, "Width": 64,
             "Pixelsize": PIXELSIZE}]
    io.save_locs(path, locs, info + ([extra_info] if extra_info else []))


def _batch_inputs(folder, le_fitting=False, granularity=6, area=True):
    """JAX's minimal CSVs (tests/test_spinna_batch_analysis.py)."""
    folder.mkdir(exist_ok=True)
    if le_fitting:
        np.random.seed(3)
        m = ts.StructureMixer(_structures(ts, ("A-only", "B-only", "AB")),
                              label_unc={"ALL": 3.0}, le={"ALL": 1.0},
                              width=5000.0, height=5000.0)
        gt = m.run_simulation([30, 30, 60])
        row = {"exp_data_A": str(folder / "exp_A.hdf5"),
               "exp_data_B": str(folder / "exp_B.hdf5"),
               "label_unc_A": "3", "label_unc_B": "3",
               "le_fitting": 1, "distances": "15"}
        _write_exp_locs(row["exp_data_A"], gt["A"])
        _write_exp_locs(row["exp_data_B"], gt["B"])
    else:
        structs = _structures(ts, ("monomer", "dimer"), target="T")
        ts.io.save_info(str(folder / "structs.yaml"),
                        [s.get_info() for s in structs])
        np.random.seed(0)
        m = ts.StructureMixer(structs, label_unc={"ALL": 3.0},
                              le={"ALL": 1.0}, width=5000.0, height=5000.0)
        _write_exp_locs(str(folder / "exp_T.hdf5"),
                        m.run_simulation([60, 70])["T"],
                        None if area else {"Area (um^2)": 25.0})
        row = {"structures_filename": str(folder / "structs.yaml"),
               "exp_data_T": str(folder / "exp_T.hdf5"), "le_T": 100.0,
               "label_unc_T": 3.0}
    row.update({"granularity": granularity, "sim_repeats": 1,
                "save_filename": "run0.csv", "NND_bin": 4.0,
                "NND_maxdist": 200.0})
    if area:
        row["area"] = 25.0
    pd.DataFrame([row]).to_csv(folder / "batch.csv", index=False)
    return str(folder / "batch.csv")


@pytest.mark.parametrize("case", ["area", "metadata", "le", "host"])
def test_batch_analysis_matches_jax(case, tmp_path):
    """The same result folder, files, summary columns and fit-score
    columns as JAX's batch_analysis; with 3 candidates (the host route)
    the same summary values."""
    kw = {"area": {}, "metadata": {"area": False},
          "le": {"le_fitting": True, "granularity": 3},
          "host": {"granularity": 3}}[case]
    out = {}
    for name, mod, extra in (("j", js, {}), ("t", ts, CPU)):
        csv_path = _batch_inputs(tmp_path / name, **kw)
        np.random.seed(21)
        out[name] = mod.batch_analysis(csv_path, fitting_mode="brute-force",
                                       **extra)
    folders = {n: tmp_path / n / "batch__fitting_results" for n in "tj"}
    names = sorted(p.name for p in folders["t"].iterdir())
    assert names == sorted(p.name for p in folders["j"].iterdir())
    assert "summary_results.csv" in names and "run0_NND.png" in names
    rows = {}
    for n in "tj":
        with open(folders[n] / "summary_results.csv") as f:
            rows[n] = list(csv.reader(f))
    assert rows["t"][0] == rows["j"][0] == list(out["t"][0])
    assert list(out["j"].columns) == list(out["t"][0])
    if case in ("host", "le"):
        assert rows["t"] == rows["j"]
    else:
        got = out["t"][0]
        assert got["prop_monomer"] + got["prop_dimer"] == pytest.approx(
            100.0, abs=0.5)
        with open(folders["t"] / "run0_fit_scores.csv") as f, \
                open(folders["j"] / "run0_fit_scores.csv") as g:
            assert f.readline() == g.readline()
    if case == "le":
        assert out["t"][0]["le_fitting"] == 1
        assert out["t"][0]["best_distance_nm"] == 15.0


def test_batch_analysis_validation_and_naming(tmp_path):
    with pytest.raises(TypeError):
        ts.batch_analysis(123, **CPU)
    with pytest.raises(TypeError):
        ts.batch_analysis("params.txt", **CPU)
    bad = tmp_path / "p.csv"
    pd.DataFrame({"granularity": [5]}).to_csv(bad, index=False)
    with pytest.raises(ValueError, match="save_filename"):
        ts.batch_analysis(str(bad), **CPU)
    csv_path = _batch_inputs(tmp_path / "x", granularity=3)
    os.makedirs(tmp_path / "x" / "batch__fitting_results_1")
    for _ in range(2):
        ts.batch_analysis(csv_path, fitting_mode="brute-force", **CPU)
    assert sorted(p.name for p in (tmp_path / "x").iterdir()
                  if "fitting" in p.name) == [
        "batch__fitting_results", "batch__fitting_results_1",
        "batch__fitting_results_2"]


def test_spinna_verbs_match_the_jax_cli(tmp_path, capsys):
    """``spinna`` (--device cpu, 3 candidates: the host route) prints what
    the JAX CLI prints; ``spinna-batch`` writes its result folder."""
    from picasso_torch import __main__ as tmain
    from picasso_tpu import __main__ as jmain

    csv_path = _batch_inputs(tmp_path, granularity=3)
    args = ["spinna", str(tmp_path / "structs.yaml"),
            str(tmp_path / "exp_T.hdf5"), "-g", "3", "-W", "5000", "-H",
            "5000", "-m", "brute-force"]
    out = {}
    for name, main, extra in (("t", tmain.main, ["--device", "cpu"]),
                              ("j", jmain.main, [])):
        np.random.seed(2)
        main(args + extra)
        out[name] = capsys.readouterr().out
    assert out["t"] == out["j"] and "KS score" in out["t"]
    tmain.main(["spinna-batch", csv_path, "-m", "brute-force", "--device",
                "cpu"])
    assert "prop_dimer" in capsys.readouterr().out
    assert (tmp_path / "batch__fitting_results" / "summary_results.csv"
            ).exists()


def test_entry_points_need_the_card_or_cpu(tmp_path):
    """device defaults to cuda: without a card SPINNA, compare_models,
    fit_le, batch_analysis and both verbs raise, whatever the route."""
    from picasso_torch import __main__ as cli

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    _, (mt, gt) = _pair(seed=1)
    csv_path = _batch_inputs(tmp_path, granularity=3)
    models = [_structures(ts, ("A-only", "B-only", "AB"))]
    data = _le_data()[1]
    calls = [
        lambda: ts.SPINNA(mt, gt),
        lambda: ts.compare_models(models, data, 3, {"A": 3.0, "B": 3.0},
                                  width=4000.0, height=4000.0),
        lambda: ts.fit_le("A", "B", data, 3, {"A": 3.0, "B": 3.0}, [15.0],
                          width=4000.0, height=4000.0),
        lambda: ts.batch_analysis(csv_path),
        lambda: cli.main(["spinna", str(tmp_path / "structs.yaml"),
                          str(tmp_path / "exp_T.hdf5"), "-W", "5000", "-H",
                          "5000"]),
        lambda: cli.main(["spinna-batch", csv_path]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not any("fitting_results" in p.name for p in tmp_path.iterdir())


def test_batched_scorer_defaults_to_the_card():
    """ops/spinna_batch.BatchedScorer built without ``device`` resolves
    "cuda" through lib.resolve_device, as JAX's scorer runs on the
    default device: without a card it raises, with one it is on it; with
    device="cpu" it is on the CPU."""
    _, (mt, gt) = _pair(seed=1)
    sp = ts.SPINNA(mt, gt, N_sim=2, **CPU)
    args = (mt, sp.dists_gt, 2, np.array([4, 4]))
    assert tb.BatchedScorer(*args, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert tb.BatchedScorer(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tb.BatchedScorer(*args)


def test_g5m_accepts_asynch_in_both_packages():
    """g5m(locs, info, asynch=False) runs in the port as in JAX (4
    groups, the host route: equal tables)."""
    from picasso_torch import g5m as tg
    from picasso_tpu import g5m as jg
    from test_torch_g5m import INFO, _clusters, _locs

    Xs, lps, _ = _clusters(80, 4)
    locs = _locs(Xs, lps)
    a = tg.g5m(locs, INFO, asynch=False, device="cpu")
    b = jg.g5m(pd.DataFrame(locs), INFO, asynch=False)
    assert len(a[0]) == len(b[0]) > 0
    for n in a[0].dtype.names:
        np.testing.assert_array_equal(a[0][n], b[0][n].to_numpy(), err_msg=n)
