"""picasso_torch/parallel/mesh.py on the CPU: every sharded function on
a mesh of CPU shards (``Mesh(["cpu"] * n)``, as JAX's tests run on
conftest's 8 virtual devices) held (a) to the port's own unsharded
function bit for bit, and (b) to picasso_tpu.parallel.mesh's sharded
function on ``jax.devices()[:n]`` within the tolerances the port already
uses: tests/torch_parity.compare_fits and compare_lq_fits for the fits,
compare_hits for the hit lists (equal but at the threshold, ng within
rtol 1e-5), the histograms equal, the pair correlations within JAX's own
bound against numpy (rtol 1e-4, atol 1e-5: JAX correlates in complex64,
the port in complex128), G5M's fits by their means, and SPINNA's scores
in distribution (as tests/test_torch_spinna.py holds the batched scorer
to JAX's). The routed callers (localize_fused, pair_xcorrs, g5m, the
SPINNA scorer) given a mesh equal their results on one device.

Mirrors tests/test_parallel.py case by case; uneven remainders, empty
shards, the global candidate and cluster indices, and the multi-device
dry run are covered."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from picasso_torch import g5m as tg
from picasso_torch import gaussmle, imageprocess
from picasso_torch import spinna as ts
from picasso_torch.ops import fused as tfused
from picasso_torch.ops import gmm as tgmm
from picasso_torch.ops import identify as tident
from picasso_torch.ops import lq as tlq
from picasso_torch.ops import winfit_cuda
from picasso_torch.parallel import mesh as tmesh
from picasso_torch.parallel.dryrun import dryrun_multichip
from picasso_tpu.parallel import mesh as jmesh
from torch_data import make_spots
from torch_parity import compare_fits, compare_hits, compare_lq_fits

CAM = {"Baseline": 10, "Sensitivity": 0.5, "Gain": 1}
MIN_NG = 2000
BOX = 7
XCORR_JAX = dict(rtol=1e-4, atol=1e-5)
G5M_MEANS_JAX = 1e-3  # px: two EMs from other kmeans++ draws
SPINNA_JAX = (0.06, 0.98)  # max |d score|, least correlation


@pytest.fixture(autouse=True)
def _threads():
    """Few torch threads a shard: the shards run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int) -> tmesh.Mesh:
    return tmesh.Mesh(["cpu"] * n)


def jax_mesh(n: int):
    return jmesh.default_mesh(jax.devices()[:n])


def _movie(n_frames=37, size=48, seed=0):
    """tests/test_parallel.py's movie: Poisson background and three
    spots a frame."""
    rng = np.random.default_rng(seed)
    frames = rng.poisson(30, (n_frames, size, size)).astype(np.uint16)
    yy, xx = np.mgrid[-3:4, -3:4]
    psf = np.exp(-(yy**2 + xx**2) / 2.4)
    for i in range(n_frames):
        for cy, cx in ((10, 10), (30, 20), (40, 40)):
            frames[i, cy - 3:cy + 4, cx - 3:cx + 4] += (
                rng.poisson(psf * 600).astype(np.uint16))
    return frames


def _unsharded_chain(frames, method, max_it=40):
    """The port's fused chain on the whole batch on the CPU, flat as
    localize_fused_sharded returns it."""
    out = tfused.identify_cut_fit(
        torch.from_numpy(frames), MIN_NG, *tfused.photon_factors(CAM), box=BOX,
        eps=1e-3, max_it=max_it, method=method)
    out = [a.numpy() for a in out]
    if method == "lq":
        return out[:4] + [out[4].T]
    return out[:4] + [out[4].T, out[5].T, out[6], out[7]]


def _assert_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _rois(frames, hits):
    """The photon ROIs (S, S, N) of hits, for compare_lq_fits."""
    return winfit_cuda.photons_t(
        torch.from_numpy(frames), *(torch.from_numpy(np.asarray(h))
                                    for h in hits[:3]), BOX,
        *tfused.photon_factors(CAM)).numpy()


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_mesh_routes_and_needs_a_card_by_default():
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.axis_names == ("spots",)
    assert tmesh.route(mesh) == (torch.device("cpu"), mesh)
    assert tmesh.route("cpu") == (torch.device("cpu"), None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tmesh.default_mesh()
        with pytest.raises(RuntimeError, match="is_available"):
            tmesh.route("cuda")
        with pytest.raises(RuntimeError, match="is_available"):
            tmesh.Mesh(["cuda:0"] * 2)
    with pytest.raises(ValueError):
        tmesh.Mesh([])


def test_cuda_routes_over_every_card(monkeypatch):
    """With two cards visible, "cuda" is the mesh of both where the
    caller spreads (localize_fused, RCC) and one card where it does not
    (G5M, SPINNA), "cuda:1" one card; a mesh given to an entry point that runs on one device raises
    rather than running on one of its devices. (Nothing touches CUDA:
    the cards are pretended.)"""
    from picasso_torch import lib, localize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    dev, mesh = tmesh.route("cuda")
    assert dev == torch.device("cuda") and mesh.devices == (
        torch.device("cuda:0"), torch.device("cuda:1"))
    assert tmesh.route("cuda", spread=False) == (torch.device("cuda"), None)
    assert tmesh.route(mesh, spread=False) == (mesh.devices[0], mesh)
    assert tmesh.route("cuda:1") == (torch.device("cuda:1"), None)
    assert tmesh.route(torch.device("cuda", 0))[1] is None
    with pytest.raises(TypeError, match="one device"):
        lib.resolve_device(mesh)
    with pytest.raises(TypeError, match="one device"):
        localize.identify(_movie(4), MIN_NG, BOX, device=cpu_mesh(2))


def test_shard_failure_is_raised_in_the_caller():
    """A failing shard raises in the caller after every shard ended; no
    shard is retried."""
    mesh = cpu_mesh(4)
    calls = []

    def fn(i, lo):
        calls.append(i)
        if i == 2:
            raise ValueError("shard 2")
        return lo

    with pytest.raises(ValueError, match="shard 2"):
        mesh.run(fn, [0, 1, 2, 3])
    assert sorted(calls) == [0, 1, 2, 3]
    assert mesh.run(lambda i, x: x * i, [1, 1, 1, 1]) == [0, 1, 2, 3]


def test_split_follows_jax_shards():
    assert tmesh._split(5, 8) == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5),
                                  (5, 5), (5, 5), (5, 5)]
    assert tmesh._split(13, 2) == [(0, 7), (7, 13)]
    assert tmesh._split(0, 2) == [(0, 0), (0, 0)]


# ---------------------------------------------------------------------------
# spot-sharded fits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spots():
    return make_spots(264, BOX, seed=0)  # deliberately not divisible by 8


@pytest.fixture(scope="module")
def jax_mle(spots):
    return {m: jmesh.fit_mle_sharded(spots, 1e-3, 40, m, mesh=jax_mesh(8))
            for m in ("sigmaxy", "sigma")}


class TestShardedFit:
    @pytest.mark.parametrize("method", ["sigmaxy", "sigma"])
    @pytest.mark.parametrize("n_dev", [1, 2, 8])
    def test_matches_single_device(self, spots, jax_mle, method, n_dev):
        got = tmesh.fit_mle_sharded(spots, 1e-3, 40, method,
                                    mesh=cpu_mesh(n_dev))
        assert got[0].shape == (264, 6) and got[3].dtype == np.int32
        _assert_equal(got, gaussmle.gaussmle(spots, 1e-3, 40, method,
                                             device="cpu"))
        compare_fits([a.T for a in jax_mle[method]], [a.T for a in got], 40,
                     f"sharded MLE {method} vs JAX")

    def test_handles_empty_ish_batch(self):
        for n in (8, 3, 0):
            theta, crlb, ll, iters = tmesh.fit_mle_sharded(
                make_spots(n, BOX, seed=1) if n else np.zeros((0, 7, 7)),
                mesh=cpu_mesh(4))
            assert theta.shape == crlb.shape == (n, 6)
            assert ll.shape == iters.shape == (n,)
            assert np.isfinite(theta[:, :2]).all()


class TestFitLQSharded:
    @pytest.mark.parametrize("n_dev", [1, 8])
    def test_matches_single_device(self, spots, n_dev):
        got = tmesh.fit_lq_sharded(spots, mesh=cpu_mesh(n_dev))
        assert got.shape == (264, 6)
        np.testing.assert_array_equal(
            got, tlq.fit_spots_batched(spots, 30, device="cpu"))
        want = jmesh.fit_lq_sharded(spots, mesh=jax_mesh(8))
        compare_lq_fits(want.T, got.T,
                        np.ascontiguousarray(spots.transpose(1, 2, 0)),
                        "sharded LQ vs JAX")


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


class TestShardedRender:
    def test_matches_numpy_histogram(self):
        rng = np.random.default_rng(1)
        n = 5000
        x = rng.uniform(-2, 34, n)
        y = rng.uniform(-2, 34, n)
        img = tmesh.render_hist_sharded(x, y, (32, 32), mesh=cpu_mesh(8))
        ok = (y >= 0) & (y < 32) & (x >= 0) & (x < 32)
        ref, *_ = np.histogram2d(np.floor(y[ok]), np.floor(x[ok]), bins=32,
                                 range=[[0, 32], [0, 32]])
        assert img.dtype == np.float32 and img.sum() == ok.sum()
        np.testing.assert_array_equal(img, ref)
        np.testing.assert_array_equal(
            img, tmesh.render_hist_sharded(x, y, (32, 32), mesh=cpu_mesh(1)))
        np.testing.assert_array_equal(
            img, jmesh.render_hist_sharded(x, y, (32, 32), mesh=jax_mesh(8)))


class TestPipelineStep:
    def test_runs_over_mesh(self):
        rng = np.random.default_rng(2)
        frames = rng.poisson(20, (16, 32, 32)).astype(np.float32)
        theta, img = tmesh.sharded_pipeline_step(frames, box=7,
                                                 mesh=cpu_mesh(8))
        assert theta.shape == (16 * 4, 6)
        assert img.shape == (7, 7)
        # every shard's spots are in the summed image
        assert img.sum() == 16 * 4
        one = tmesh.sharded_pipeline_step(frames, box=7, mesh=cpu_mesh(1))
        _assert_equal((theta, img), one)

    def test_matches_jax_step(self):
        """The same spots fitted as JAX's step picks them (top 4 by net
        gradient, a frame with fewer maxima filled with its first
        pixels), so the image is JAX's and the fits agree as fits do."""
        frames = _movie(8).astype(np.float32)
        frames[5] = 0.0  # no maxima: top_k's -inf fill, pixels 0..3
        theta, img = tmesh.sharded_pipeline_step(frames, box=7,
                                                 mesh=cpu_mesh(4))
        j_theta, j_img = jmesh.sharded_pipeline_step(frames, box=7,
                                                     mesh=jax_mesh(4))
        np.testing.assert_array_equal(img, j_img)
        ok = np.isfinite(j_theta).all(1)
        np.testing.assert_allclose(theta[ok, :2], j_theta[ok, :2],
                                   rtol=0, atol=1e-3)
        np.testing.assert_array_equal(np.isfinite(theta).all(1), ok)


# ---------------------------------------------------------------------------
# RCC pair correlations
# ---------------------------------------------------------------------------


class TestPairXcorrsSharded:
    def test_matches_numpy_fft(self):
        rng = np.random.default_rng(4)
        segments = rng.random((6, 16, 16)).astype(np.float32)
        pairs = imageprocess.segment_pairs(6)
        ii = np.array([p[0] for p in pairs])
        jj = np.array([p[1] for p in pairs])
        out = tmesh.pair_xcorrs_sharded(segments, ii, jj, mesh=cpu_mesh(8))
        F = np.fft.fft2(segments)
        ref = np.fft.fftshift(np.real(np.fft.ifft2(F[ii] * np.conj(F[jj]))),
                              axes=(1, 2)) / np.sqrt(16 * 16)
        assert out.shape == (len(pairs), 16, 16)
        np.testing.assert_allclose(out, ref, **XCORR_JAX)
        crops, _ = imageprocess.pair_xcorrs(torch.from_numpy(segments), None)
        np.testing.assert_array_equal(out, crops)
        np.testing.assert_allclose(
            out, jmesh.pair_xcorrs_sharded(segments, ii, jj,
                                           mesh=jax_mesh(8)), **XCORR_JAX)

    def test_routed_undrift(self, monkeypatch):
        """postprocess.undrift over a mesh (the pairs split, with the
        threshold at 0) == on the CPU."""
        from picasso_torch import postprocess

        rng = np.random.default_rng(6)
        n = 6000
        locs = np.zeros(n, [("frame", np.uint32), ("x", np.float32),
                            ("y", np.float32), ("lpx", np.float32),
                            ("lpy", np.float32)])
        locs["frame"] = np.sort(rng.integers(0, 2000, n))
        site = rng.integers(0, 12, n)
        drift = 0.5 * locs["frame"] / 2000.0
        locs["x"] = 4 + 2.5 * (site % 4) + drift + rng.normal(0, 0.05, n)
        locs["y"] = 4 + 2.5 * (site // 4) + rng.normal(0, 0.05, n)
        locs["lpx"] = locs["lpy"] = 0.05
        info = [{"Frames": 2000, "Height": 16, "Width": 16}]
        monkeypatch.setattr(imageprocess, "DEVICE_PAIR_PIXELS", 0)
        got = postprocess.undrift(locs, info, 400, device=cpu_mesh(3))
        want = postprocess.undrift(locs, info, 400, device="cpu")
        for a, b in zip(got, want):
            for name in b.dtype.names:
                np.testing.assert_array_equal(a[name], b[name])

    def test_routed_pair_xcorrs_and_rcc(self, monkeypatch):
        """pair_xcorrs and rcc given a mesh: the same crops and shifts;
        the mesh splits the pairs only above DEVICE_PAIR_PIXELS."""
        rng = np.random.default_rng(5)
        seg = torch.from_numpy(rng.poisson(3.0, (5, 32, 32)).astype(
            np.float32))
        seg[:, 10:13, 12:15] += 50.0
        seg[3] = torch.roll(seg[3], (1, 2), (0, 1))
        mesh = cpu_mesh(4)
        calls = []
        orig = tmesh.pair_xcorrs_crops
        monkeypatch.setattr(tmesh, "pair_xcorrs_crops",
                            lambda *a: calls.append(1) or orig(*a))
        one = imageprocess.pair_xcorrs(seg, 12)
        below = imageprocess.pair_xcorrs(seg, 12, mesh)
        assert not calls
        monkeypatch.setattr(imageprocess, "DEVICE_PAIR_PIXELS", 0)
        above = imageprocess.pair_xcorrs(seg, 12, mesh)
        assert calls
        for got in (below, above):
            np.testing.assert_array_equal(got[0], one[0])
            assert got[1] == one[1]
        np.testing.assert_array_equal(imageprocess.rcc(seg, 12, mesh),
                                      imageprocess.rcc(seg, 12))


# ---------------------------------------------------------------------------
# frame-sharded identify and the fused chain
# ---------------------------------------------------------------------------


class TestIdentifySharded:
    @pytest.mark.parametrize("n_dev", [1, 2, 8])
    def test_matches_single_device(self, n_dev):
        frames = _movie()
        got = tmesh.identify_sharded(frames, MIN_NG, 7, mesh=cpu_mesh(n_dev))
        want = tident.identify_frames(frames, MIN_NG, 7, device="cpu")
        _assert_equal(got, want)
        assert got[0].dtype == np.int64 and got[3].dtype == np.float32
        if n_dev == 8:
            j = jmesh.identify_sharded(frames, MIN_NG, 7, mesh=jax_mesh(8))
            assert len(compare_hits(j, got, MIN_NG)) == len(got[0])

    def test_empty_and_bucket_growth(self):
        flat = np.zeros((16, 32, 32), np.uint16)
        f, y, x, ng = tmesh.identify_sharded(flat, 100.0, 5, mesh=cpu_mesh(8))
        assert len(f) == 0
        dense = np.zeros((8, 32, 32), np.uint16)
        dense[:, 4:28:4, 4:28:4] = 1000
        got = tmesh.identify_sharded(dense, 10.0, 3, mesh=cpu_mesh(8),
                                     bucket=2)
        assert len(got[0]) > 16
        _assert_equal(got, tident.identify_frames(dense, 10.0, 3,
                                                  device="cpu"))


@pytest.fixture(scope="module")
def movie():
    return _movie()


class TestLocalizeFusedSharded:
    @pytest.mark.parametrize("method", ["lq", "sigmaxy", "sigma"])
    def test_bit_identical_to_single_device(self, movie, method):
        got = tmesh.localize_fused_sharded(movie, MIN_NG, BOX, CAM,
                                           mesh=cpu_mesh(8), method=method,
                                           max_it=40)
        want = _unsharded_chain(movie, method)
        assert len(got[0]) == len(want[0]) > 0
        _assert_equal(got[:len(want)], want)
        if method != "sigma":  # JAX's fused chain has sigmaxy and lq
            j = jmesh.localize_fused_sharded(movie, MIN_NG, BOX, CAM,
                                             mesh=jax_mesh(8), method=method,
                                             max_it=40)
            assert len(compare_hits(j[:4], got[:4], MIN_NG)) == len(got[0])
            if method == "lq":
                compare_lq_fits(j[4].T, got[4].T, _rois(movie, got),
                                "sharded fused LQ vs JAX")
            else:
                compare_fits([j[4].T, j[5].T, j[6], j[7]],
                             [got[4].T, got[5].T, got[6], got[7]], 40,
                             "sharded fused MLE vs JAX")

    def test_empty_and_bucket_growth(self):
        cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1}
        flat = np.zeros((16, 32, 32), np.uint16)
        out = tmesh.localize_fused_sharded(flat, 100.0, 5, cam,
                                           mesh=cpu_mesh(8))
        assert len(out[0]) == 0 and out[4].shape == (0, 6)
        assert out[7].dtype == np.int32
        dense = np.zeros((8, 32, 32), np.uint16)
        dense[:, 4:28:4, 4:28:4] = 1000
        out = tmesh.localize_fused_sharded(dense, 10.0, 3, cam,
                                           mesh=cpu_mesh(8), bucket=2)
        assert len(out[0]) > 16
        assert out[4].shape == (len(out[0]), 6)

    def test_pallas_flags_change_nothing(self, movie):
        """JAX's Pallas-cores case: here the flags (and the bucket) are
        accepted and the chain is the same."""
        kw = dict(mesh=cpu_mesh(4), method="lq", max_it=40)
        a = tmesh.localize_fused_sharded(movie, MIN_NG, BOX, CAM, **kw)
        b = tmesh.localize_fused_sharded(movie, MIN_NG, BOX, CAM, bucket=1,
                                         use_pallas=True,
                                         pallas_interpret=True, **kw)
        _assert_equal(a, b)

    @pytest.mark.parametrize("n_dev", [1, 2, 8])
    @pytest.mark.parametrize("n_frames", [5, 13])
    def test_uneven_remainders_and_submeshes(self, movie, n_dev, n_frames):
        frames = movie[:n_frames]
        got = tmesh.localize_fused_sharded(frames, MIN_NG, BOX, CAM,
                                           mesh=cpu_mesh(n_dev), method="lq",
                                           max_it=40)
        _assert_equal(got[:5], _unsharded_chain(frames, "lq"))
        j = jmesh.localize_fused_sharded(frames, MIN_NG, BOX, CAM,
                                         mesh=jax_mesh(n_dev), method="lq",
                                         max_it=40)
        assert len(compare_hits(j[:4], got[:4], MIN_NG)) == len(got[0])
        compare_lq_fits(j[4].T, got[4].T, _rois(frames, got),
                        f"{n_frames} frames on {n_dev} shards vs JAX")

    def test_empty_shard_chunk(self, movie):
        """A shard whose frames hold no hits leaves the others alone."""
        frames = movie[:8].copy()
        frames[4:] = 0  # the second shard: no spots at all
        f, y, x, ng, th, *_ = tmesh.localize_fused_sharded(
            frames, MIN_NG, BOX, CAM, mesh=cpu_mesh(2), method="lq",
            max_it=40)
        assert len(f) > 0 and (f < 4).all()
        assert np.isfinite(th).all()

    def test_sixteen_shards(self):
        """16 shards (JAX's subprocess case) on an uneven 22-frame
        movie, equal to the unsharded chain."""
        frames = _movie(22, seed=2)
        got = tmesh.localize_fused_sharded(frames, MIN_NG, BOX, CAM,
                                           mesh=cpu_mesh(16), method="lq",
                                           max_it=40)
        assert len(got[0]) > 0
        _assert_equal(got[:5], _unsharded_chain(frames, "lq"))


@pytest.mark.parametrize("method", ["gaussmle-sigmaxy", "gaussmle-sigma",
                                    "gausslq"])
def test_routed_localize_fused_equals_one_device(movie, method):
    """localize_fused over a mesh (frame_chunk 16: three chunks, the last
    short, each split over 4 shards) == on the CPU, identifications and
    fits bit for bit; the perf keys stay."""
    fitting, _, mle = method.partition("-")
    kw = dict(fitting_method=fitting, mle_method=mle or "sigmaxy",
              frame_chunk=16, max_it=40)
    perf = {}
    got = tfused.localize_fused(movie, MIN_NG, BOX, CAM, device=cpu_mesh(4),
                                perf=perf, **kw)
    want = tfused.localize_fused(movie, MIN_NG, BOX, CAM, device="cpu", **kw)
    for name in want[0].dtype.names:
        np.testing.assert_array_equal(got[0][name], want[0][name])
    _assert_equal(got[1], want[1])
    assert perf["n_chunks"] == 3 and perf["frame_chunk"] == 16
    assert {"decode_wait_s", "upload_dispatch_s", "chain_dispatch_s",
            "drain_s", "other_s", "total_s"} <= set(perf)


# ---------------------------------------------------------------------------
# SPINNA candidates and G5M clusters
# ---------------------------------------------------------------------------


def _spinna_pair(counts=(200, 400), seed=1):
    """The same monomer + dimer mixer in both packages and its ground
    truth, drawn under one seed."""
    from picasso_tpu import spinna as js

    out = []
    for mod in (js, ts):
        mono = mod.Structure("monomer")
        mono.define_coordinates("A", [0.0], [0.0], [0.0])
        dim = mod.Structure("dimer")
        dim.define_coordinates("A", [-10.0, 10.0], [0.0, 0.0], [0.0, 0.0])
        mixer = mod.StructureMixer([mono, dim], label_unc={"A": 2.0},
                                   le={"A": 0.9}, width=3000.0,
                                   height=3000.0)
        np.random.seed(seed)
        out.append((mixer, mixer.run_simulation(list(counts))))
    return out


class TestSpinnaScoreSharded:
    @pytest.mark.parametrize("n_dev", [1, 2, 8])
    def test_bit_identical_to_unsharded(self, n_dev):
        """Each shard draws by the global candidate index, so the scores
        equal the unsharded scorer's bit for bit (JAX: partitionable
        threefry)."""
        _, (mixer, gt) = _spinna_pair(seed=0)
        sp = ts.SPINNA(mixer, gt, N_sim=2, device="cpu")
        rows = np.array([[20, 40], [40, 30], [60, 20], [80, 10], [100, 0]])
        scorer = sp._get_batched_scorer(rows)
        sharded = tmesh.spinna_score_sharded(scorer, rows, seed=7,
                                             mesh=cpu_mesh(n_dev))
        np.testing.assert_array_equal(sharded, scorer.score(rows, seed=7))
        assert np.all((sharded >= 0) & (sharded <= 1))

    def test_matches_jax_sharded_in_distribution(self):
        (mj, gj), (mt, gt) = _spinna_pair()
        rows = mt.convert_N_structures_to_array(ts.generate_N_structures(
            mt.structures, {"A": 1000}, granularity=9))
        from picasso_tpu import spinna as js

        jscorer = js.SPINNA(mj, gj, N_sim=8)._get_batched_scorer(rows)
        want = jmesh.spinna_score_sharded(jscorer, rows, seed=7,
                                          mesh=jax_mesh(8))
        scorer = ts.SPINNA(mt, gt, N_sim=8, device="cpu")._get_batched_scorer(
            rows)
        got = tmesh.spinna_score_sharded(scorer, rows, seed=7,
                                         mesh=cpu_mesh(8))
        assert np.max(np.abs(got - want)) < SPINNA_JAX[0]
        assert np.corrcoef(got, want)[0, 1] > SPINNA_JAX[1]
        assert abs(int(np.argmin(got)) - int(np.argmin(want))) <= 1

    def test_routed_scorer_and_fit(self):
        """BatchedScorer and SPINNA given a mesh split the candidates
        and score as on one device; the shards' copies are made once."""
        _, (mixer, gt) = _spinna_pair(seed=2)
        rows = mixer.convert_N_structures_to_array(ts.generate_N_structures(
            mixer.structures, {"A": 600}, granularity=5))
        mesh = cpu_mesh(3)
        sp_m = ts.SPINNA(mixer, gt, N_sim=2, device=mesh)
        sp_1 = ts.SPINNA(mixer, gt, N_sim=2, device="cpu")
        scorer = sp_m._get_batched_scorer(rows)
        assert scorer.mesh is mesh and scorer.device.type == "cpu"
        done = []
        got = scorer.score(rows, seed=3, progress=done.append)
        np.testing.assert_array_equal(
            got, sp_1._get_batched_scorer(rows).score(rows, seed=3))
        assert done == [len(rows)] and len(scorer._copies) == 1
        np.random.seed(5)
        fit_m = sp_m.fit(rows, fitting_mode="brute-force")
        np.random.seed(5)
        fit_1 = sp_1.fit(rows, fitting_mode="brute-force")
        np.testing.assert_array_equal(fit_m[0], fit_1[0])
        assert fit_m[1] == fit_1[1]


def _g5m_clusters(seed=3, n=11):
    """tests/test_parallel.py's clusters, two 2D blobs of sigma 1.5 px a
    cluster, with the blobs 15 px apart (JAX's draw them anywhere in 50
    px, where two may overlap and the EM's answer hangs on its draws)."""
    rng = np.random.default_rng(seed)
    Xs, lps = [], []
    for _ in range(n):  # 11: not divisible by 8
        c0 = rng.uniform(0, 50, 2)
        a = rng.uniform(0, np.pi)
        centers = [c0, c0 + 15 * np.array([np.cos(a), np.sin(a)])]
        pts = np.concatenate([c + rng.normal(0, 1.5, (rng.integers(15, 30), 2))
                              for c in centers]).astype(np.float32)
        Xs.append(pts)
        lps.append(np.full(len(pts), 0.5, np.float32))
    return Xs, lps


class TestG5MClustersSharded:
    KW = dict(K=2, sigma_bounds=(0.1, 10.0), isotropic=True,
              loc_local=False, min_locs=4)

    @pytest.mark.parametrize("n_dev", [1, 2, 8, 16])
    def test_matches_unsharded(self, n_dev):
        """Each shard's kmeans++ uniforms are its clusters' by global
        index: the fit equals gmm.fit_g5m_batched's on all clusters bit
        for bit (16 shards: five empty)."""
        Xs, lps = _g5m_clusters()
        X, mask, lp = tgmm.pad_clusters(Xs, lps, max(len(x) for x in Xs))
        u = tgmm.kmeans_uniforms(len(X), 2, 2, seed=5)
        got = tmesh.fit_g5m_clusters_sharded(X, mask, lp, u, n_init=2,
                                             mesh=cpu_mesh(n_dev), **self.KW)
        want = tgmm.fit_g5m_batched(*map(torch.from_numpy, (X, mask, lp, u)),
                                    **self.KW)
        for s, r in zip(got, want):
            assert s.shape == tuple(r.shape)
            np.testing.assert_array_equal(s, r.numpy())

    def test_matches_jax_sharded(self):
        """Against JAX's sharded EM from its own draws: both find the
        same two blobs a cluster."""
        Xs, lps = _g5m_clusters()
        X, mask, lp = tgmm.pad_clusters(Xs, lps, max(len(x) for x in Xs))
        got = tmesh.fit_g5m_clusters_sharded(X, mask, lp, n_init=2,
                                             mesh=cpu_mesh(8), **self.KW)
        want = jmesh.fit_g5m_clusters_sharded(X, mask, lp,
                                              jax.random.PRNGKey(5),
                                              n_init=2, mesh=jax_mesh(8),
                                              **self.KW)
        assert all(s.shape == r.shape for s, r in zip(got, want))
        assert got[7].all() and want[7].all()

        def ordered(means):  # components by x
            return np.take_along_axis(
                means, np.argsort(means[..., 0], axis=1)[..., None], 1)

        np.testing.assert_allclose(ordered(got[1]), ordered(want[1]),
                                   rtol=0, atol=G5M_MEANS_JAX)


def test_routed_g5m_equals_one_device():
    """g5m over a mesh (and its record) == on one device: the batched
    route's clusters split over the shards, each fit alike."""
    from test_torch_g5m import INFO, _clusters, _locs
    from torch_parity import compare_g5m

    Xs, lps, _ = _clusters(62, 10, 2, sizes=(130, 250))
    locs = _locs(Xs, lps)
    rec_m, rec_1 = {}, {}
    got = tg.g5m(locs, INFO, device=cpu_mesh(4), record=rec_m,
                 postprocess=False)
    want = tg.g5m(locs, INFO, device="cpu", record=rec_1, postprocess=False)
    for name in want[0].dtype.names:
        np.testing.assert_array_equal(got[0][name], want[0][name])
    for key in ("fit", "bics", "tie", "group_input"):
        assert rec_m[key] == rec_1[key], key
    out = compare_g5m(got[0], rec_m, want[0], rec_1, locs)
    assert out["worst_same"] == 0 and not out["stepped"]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_dryrun_multichip_on_cpu_shards():
    line = dryrun_multichip(4, devices=["cpu"] * 4)
    assert line.startswith("dryrun_multichip OK on 4 devices (1 distinct)")
    with pytest.raises(AssertionError, match="need 5 devices"):
        dryrun_multichip(5, devices=["cpu"] * 4)


def test_dryrun_lq_bounds_are_the_rounding_floor():
    """The dry run's K5 bounds are a small multiple of f32 rounding: on
    its 32 Gaussian spots, a 1e-6 relative change of the input moves the
    plain LM fits (which stop on a 1e-6 relative cost change) by more
    than a tenth of each bound, and within it; the fits find the spots
    drawn."""
    from picasso_torch.parallel import dryrun as dr

    frames, truth = dr.spot_frames(np.random.default_rng(0), 8)
    base = torch.from_numpy(frames.astype(np.float32))

    def fit(t):
        return tfused.identify_cut_fit_packed(
            t, 300.0, 0.0, 1.0, box=5, eps=1e-3, max_it=20,
            method="lq").numpy()

    ref = fit(base)
    assert ref.shape[1] == len(truth)
    xy = np.stack([ref[1] + ref[5], ref[2] + ref[4]], 1)
    assert np.abs(xy - truth[:, 1:]).max() <= dr.TRUTH_XY
    gaps = []
    for k in range(1, 6):
        noise = np.random.default_rng(k).standard_normal(frames.shape)
        out = fit(base * (1 + 1e-6 * torch.from_numpy(noise.astype(
            np.float32))))
        np.testing.assert_array_equal(out[:3], ref[:3])
        gaps.append(dr.lq_gaps(out[4:10].T, ref[4:10].T))
    gap_xy, gap_rel = np.max(gaps, axis=0)
    assert dr.LQ_XY / 10 < gap_xy <= dr.LQ_XY, gap_xy
    assert dr.LQ_REL / 10 < gap_rel <= dr.LQ_REL, gap_rel
