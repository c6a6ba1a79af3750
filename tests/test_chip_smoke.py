"""`chip_smoke.py`: its comparison helpers, its refusal to run without a GPU,
and a rehearsal of every phase at a tiny size on the CPU backend (the same
code the card runs, with the CPU standing in for both devices)."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(
    n_fovs=2, hw=128, channels=6, n_cells=(80, 100), full_batch=1,
    ref_hw=64, bmu_rows=8192, max_k=5,
    full_config=(("stage_sizes", (1, 1, 1, 1)), ("base_width", 16),
                 ("fpn_channels", 64), ("head_upsample_filters", 32),
                 ("head_dense_features", 64)))


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "500.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
])
def test_parse_nvidia_smi(text, want):
    assert cs.parse_nvidia_smi(text) == want


def test_parse_nvidia_smi_rejects_empty():
    with pytest.raises(cs.SmokeFailure):
        cs.parse_nvidia_smi("\n")


def test_instance_f1():
    truth = np.zeros((20, 20), np.int32)
    truth[2:8, 2:8], truth[10:16, 10:16], truth[2:6, 12:18] = 1, 2, 3
    assert cs.instance_f1(truth, truth) == 1.0
    renumbered = np.select([truth == 1, truth == 2, truth == 3],
                           [7, 5, 9], 0)
    assert cs.instance_f1(renumbered, truth) == 1.0
    missing = np.where(truth == 3, 0, truth)           # 2 of 3 found
    assert cs.instance_f1(missing, truth) == pytest.approx(2 * 2 / 5)
    shrunk = truth.copy()
    shrunk[2:8, 2:7] = 0                               # IoU 1/6 < 0.5
    assert cs.instance_f1(shrunk, truth) == pytest.approx(2 * 2 / 6)


def test_bmu_check_accepts_exact_and_near_ties(rng):
    x = rng.random((20000, 4)).astype(np.float32)
    w = rng.random((10, 4)).astype(np.float32)
    d = ((x[:, None].astype(np.float64) - w[None]) ** 2).sum(-1)
    assert cs.bmu_check(d.argmin(1), x, w)["disagreements"] == 0
    w_tied = np.concatenate([w, w[:1]])                # node 10 == node 0
    idx = d.argmin(1)
    idx[np.nonzero(idx == 0)[0][0]] = 10               # one row picks the twin
    res = cs.bmu_check(idx, x, w_tied)
    assert res["disagreements"] == 1 and res["worst_gap"] == 0.0


def test_bmu_check_rejects_wrong_assignments(rng):
    x = rng.random((500, 4)).astype(np.float32)
    w = rng.random((10, 4)).astype(np.float32)
    d = ((x[:, None].astype(np.float64) - w[None]) ** 2).sum(-1)
    idx = d.argmin(1)
    idx[:3] = (idx[:3] + 1) % 10
    with pytest.raises(cs.SmokeFailure):
        cs.bmu_check(idx, x, w)


def test_quant_oracle(rng):
    labels = np.zeros((6, 7), np.int32)
    labels[1:3, 1:4], labels[4:6, 5:7] = 3, 8
    image = rng.random((6, 7, 2)).astype(np.float32)
    ids, areas, sums = cs.quant_oracle(labels, image)
    np.testing.assert_array_equal(ids, [3, 8])
    np.testing.assert_array_equal(areas, [6, 4])
    np.testing.assert_allclose(sums[0], image[1:3, 1:4].sum((0, 1)),
                               rtol=1e-6)


def _relief(rng, hw=24, n_markers=5):
    import scipy.ndimage as ndi

    elev = ndi.gaussian_filter(rng.random((hw, hw)), 2).astype(np.float32)
    mask = ndi.gaussian_filter(rng.random((hw, hw)), 3) > 0.45
    markers = np.zeros((hw, hw), np.int32)
    ys, xs = np.nonzero(mask)
    pick = rng.choice(len(ys), n_markers, replace=False)
    markers[ys[pick], xs[pick]] = np.arange(1, n_markers + 1)
    return elev, mask, markers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_claim_levels_match_dijkstra_oracle(seed):
    """Every (label, masked pixel) claim level equals the per-label
    Dijkstra of tests/ops/test_watershed_device.py."""
    from ark_tpu.ops import watershed as W
    from tests.ops.test_watershed_device import _minimax_claim_levels

    rng = np.random.default_rng(seed)
    elev, mask, markers = _relief(rng)
    q = np.asarray(W._quantize(jax.numpy.asarray(elev[None]),
                               jax.numpy.asarray(mask[None]), 256))[0]
    want = _minimax_claim_levels(q, mask, markers)
    ys, xs = np.nonzero(mask)
    for lab, claim in want.items():
        got = cs.claim_levels(q, mask, markers, np.full(ys.shape, lab),
                              ys, xs)
        ref = claim[ys, xs]
        np.testing.assert_array_equal(
            got, np.where(ref >= 10 ** 9, q.max() + 1, ref))


def test_watershed_contract_accepts_tie_ownership(rng):
    """The device flood against the host flood on relief with plateaus
    (ties): accepted; a pixel moved to a label that is not co-optimal, or
    a coverage change, is refused."""
    from ark_tpu.ops import watershed as W

    elev, mask, markers = _relief(rng, hw=40, n_markers=8)
    elev = np.round(elev * 20) / 20                  # plateaus -> ties
    host = W.watershed(elev, markers, mask)
    dev = np.asarray(W.watershed_device(elev, markers, mask)[0])
    q = np.asarray(W._quantize(jax.numpy.asarray(elev[None]),
                               jax.numpy.asarray(mask[None]), 256))[0]
    res = cs.watershed_contract(dev, host, q, mask, markers, min_agree=0.9)
    assert res["coverage_mismatch_px"] == 0 and res["disagreements"] > 0
    # a marker pixel claimed by another label is never a tie
    y, x = np.argwhere(markers == 1)[0]
    wrong = dev.copy()
    wrong[y, x] = 2
    with pytest.raises(cs.SmokeFailure):
        cs.watershed_contract(wrong, host, q, mask, markers, min_agree=0.9)
    dropped = dev.copy()
    dropped[y, x] = 0
    with pytest.raises(cs.SmokeFailure):
        cs.watershed_contract(dropped, host, q, mask, markers, min_agree=0.9)


def test_small_object_filter_matches_host_filter(rng):
    from ark_tpu.ops import morphology

    labels = rng.integers(0, 40, (30, 30)).astype(np.int32)
    for size in (0, 15, 30):
        np.testing.assert_array_equal(
            cs.small_object_filter(labels, size),
            morphology.remove_small_objects(labels, min_size=size))


def test_ulp_distance():
    one = np.float32(1.0)
    up = np.nextafter(one, np.float32(2))
    assert cs.ulp_distance(one, up) == 1
    assert cs.ulp_distance(np.float32(-0.0), np.float32(0.0)) == 0
    assert cs.ulp_distance(np.float32(-1.0), np.float32(1.0)) > 1e9


def test_csv_drift(tmp_path):
    import pandas as pd

    table = pd.DataFrame({"fov": ["fov0", "fov1"], "label": [1, 2],
                          "chan0": [0.5, 2.0]})
    paths = [str(tmp_path / f"{n}.csv") for n in "abcd"]
    table.to_csv(paths[0], index=False)
    table.to_csv(paths[1], index=False)
    assert cs.csv_drift(paths[0], paths[1]) == {}
    # drift is held to the column's scale: 1e-6 on the 0.5 entry of a
    # column whose largest value is 2.0
    table.assign(chan0=[0.5 + 1e-6, 2.0]).to_csv(paths[2], index=False)
    drift = cs.csv_drift(paths[0], paths[2])
    assert drift["label"] == 0.0
    assert drift["chan0"] == pytest.approx(0.5e-6, rel=1e-3)
    table.assign(fov=["fov0", "fov2"]).to_csv(paths[3], index=False)
    with pytest.raises(cs.SmokeFailure):
        cs.csv_drift(paths[0], paths[3])


@pytest.mark.parametrize("drift,ok", [
    ({}, True),
    ({"chan0": 5e-6, "eccentricity": 5e-5}, True),
    ({"chan0": 5e-5, "eccentricity": 5e-5}, False),    # a marker channel
    ({"chan0": 5e-6, "eccentricity": 5e-4}, False),    # any column
])
def test_check_drift_bounds(drift, ok, capsys):
    rep = cs.Report(None)
    if ok:
        cs.check_drift(rep, "segment", "t.csv", drift, ["chan0"])
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.check_drift(rep, "segment", "t.csv", drift, ["chan0"])
    out = capsys.readouterr().out
    assert ("run_to_run=bitwise" in out) == (not drift)


def _run_script(cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_exits_nonzero_without_gpu():
    res = _run_script(REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_script(str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_every_phase_rehearsed_on_cpu(capsys):
    cpu = jax.devices("cpu")[0]
    cs.run_all(TINY, cpu, cpu)
    out = capsys.readouterr().out
    for phase in ("mesmer_full", "segment", "watershed", "pixel", "cell",
                  "spatial"):
        assert f"[{phase}]" in out, phase
    assert "run_to_run=bitwise" in out


def test_four_device_path_rehearsed_on_cpu(capsys):
    cs.run_four(TINY, jax.devices("cpu")[:4])
    out = capsys.readouterr().out
    assert "labels_identical=True" in out
    assert "path=som_train_sharded" in out


@pytest.mark.gpu
def test_every_phase_on_gpu_at_tiny_size(gpu_device):
    cs.run_all(TINY, gpu_device, jax.devices("cpu")[0])
