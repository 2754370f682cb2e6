"""The traffic generator: a seed repeats exactly, two seeds differ, and a
pair holds its planted motion and the dataset contract's DCP form."""

import numpy as np
import pytest

from portbench import traffic as TF

SPECS = ["full", "refine", "train_b4", "train_b32"]


@pytest.mark.parametrize("name", SPECS)
def test_a_seed_repeats_exactly_and_two_seeds_differ(name):
    spec = dict(TF.load(name), points=256)
    seed = 2**31 + 12345
    a = TF.pair(spec, seed, 3)
    b = TF.pair(spec, seed, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = TF.pair(spec, seed + 1, 3)
    d = TF.pair(spec, seed, 4)
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], d[0])
    assert a[0].dtype == np.float32 and a[0].shape == (256, 3)


@pytest.mark.parametrize("name", SPECS)
def test_the_planted_motion_stays_within_the_traffic_range(name):
    spec = TF.load(name)
    for i in range(20):
        _, _, R, t = TF.pair(dict(spec, points=32), 7, i)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        assert np.linalg.det(R) == pytest.approx(1.0)
        angle = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
        if "max_deg" in spec:
            assert angle <= spec["max_deg"] + 1e-9
            assert np.linalg.norm(t) <= spec["max_trans"] + 1e-12
        else:
            assert np.all(np.abs(t) <= spec["trans_range"])


def test_target_is_the_moved_surface_and_the_dcp_item_holds_the_motion():
    spec = dict(TF.load("train_b4"), noise=0.0)
    src, tar, R, t = TF.pair(spec, 11, 0)
    it = TF.dcp_item(src, tar, R, t)
    # the surface itself moves: without noise, the moved source lies on it
    # about as far from the target's points as the samples' spacing
    moved = it["points_src_sample"] @ it["R"].T + it["T"]
    d = ((moved[:, None, :] - it["points_tar_sample"][None]) ** 2).sum(-1).min(1)
    assert np.sqrt(d).mean() < 0.1
    np.testing.assert_allclose(it["R"] @ it["R_inv"], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(it["T_inv"], -it["R"].T @ it["T"], atol=1e-6)
    assert it["tar_box"][0].tolist() == it["points_tar_sample"].max(0).tolist()
    assert it["tar_box"][7].tolist() == it["points_tar_sample"].min(0).tolist()
    assert abs(it["centers"]).max() < 1e-5
