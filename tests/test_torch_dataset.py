"""The port's data layer (data/dataset.py, data/transforms.py) against the
JAX package's, on the CPU.

Both read the same fixture, written with numpy as tests/test_data.py
writes its own (two pairs in the indexed layout with normals and
transform companions, a third pair without either, neighbour buffers from
the JAX package's precompute), and every array they produce must be
EQUAL: the items of ``load_pair`` plain and in the DCP and FMR forms,
``corrupt_pair``, the ``Loader``'s and ``PrefetchLoader``'s batches,
``generate_datasets``' splits in both layouts, the companion rule, the
transforms, and ``DeviceCache(device="cpu")``'s batches against the
``Loader``'s.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from a_robust_registration_loss_tpu.data import dataset as JDS
from a_robust_registration_loss_tpu.data import objio as JO
from a_robust_registration_loss_tpu.data import precompute as JP
from a_robust_registration_loss_tpu.data import transforms as JT
from a_robust_registration_loss_tpu_torch.data import dataset as DS
from a_robust_registration_loss_tpu_torch.data import transforms as T
from torch_port_helpers import sphere_cloud

torch.set_num_threads(1)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
        assert x.dtype == b[k].dtype and np.array_equal(x, b[k]), k


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Three pairs of the indexed layout: 0 and 1 with normals and
    transform companions, 2 without either and with a shorter target (the
    FMR adapter truncates it); the same clouds again in the views layout
    (2 meshes x 2 views, the last view missing)."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(42)
    for i in range(3):
        src = sphere_cloud(120, rng, noise=0.01) + rng.standard_normal(3).astype(np.float32)
        ang = 0.4 + 0.1 * i
        R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                      [0, 0, 1.0]])
        T_ = rng.standard_normal(3) * 0.3
        tar = (src.astype(np.float64) @ R + T_).astype(np.float32)
        JO.write_obj(str(root / f"{i}_src_sample.obj"), src)
        JO.write_obj(str(root / f"{i}_tar_sample.obj"), tar[:113] if i == 2 else tar)
        if i < 2:
            nrm = rng.standard_normal((120, 3)).astype(np.float32)
            JO.write_obj(str(root / f"{i}_src_sample_normals.obj"), nrm)
            JO.write_obj(str(root / f"{i}_tar_sample_normals.obj"), nrm)
            np.concatenate([R, T_[:, None]], 1).tofile(str(root / f"{i}_transform.bin"))
    JP.main(["--data_path", str(root), "--num_sample", "32"])
    views = root / "views"
    views.mkdir()
    for m in range(2):
        for v in range(2 - m):
            i = m * 2 + v
            for tag in ("src", "tar"):
                if i < 3:
                    shutil.copy(root / f"{i}_{tag}_sample.obj", views / f"{tag}_sample_{m}_{v}.obj")
                    shutil.copy(root / f"{i}_{tag}_sample_neigh.bin",
                                views / f"{tag}_sample_{m}_{v}_neigh.bin")
    return root


@pytest.mark.parametrize("form", ["plain", "dcp", "fmr"])
@pytest.mark.parametrize("i", [0, 2])
def test_load_pair_equals_jax(pairs, form, i):
    src, tar = str(pairs / f"{i}_src_sample.obj"), str(pairs / f"{i}_tar_sample.obj")
    kw = {"plain": {}, "dcp": {"dcp": True}, "fmr": {"fmr": True}}[form]
    _equal(DS.load_pair(src, tar, **kw), JDS.load_pair(src, tar, **kw))


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(noise_type="jitter", rot_mag=30.0, trans_mag=0.2),
    dict(noise_type="crop", num_points=90, rot_mag=45.0, trans_mag=0.5),
], ids=["clean", "jitter_rot_trans", "crop_subsample_rot_trans"])
def test_corrupt_pair_equals_jax(pairs, cfg):
    item = JDS.load_pair_plain(str(pairs / "0_src_sample.obj"), str(pairs / "0_tar_sample.obj"))
    got = DS.corrupt_pair(item, DS.CorruptConfig(**cfg), np.random.default_rng(7))
    want = JDS.corrupt_pair(item, JDS.CorruptConfig(**cfg), np.random.default_rng(7))
    _equal(got, want)


def _loaders(pairs, corrupt=None, layout="indexed"):
    kw = dict(data_path=str(pairs / "views") if layout == "views" else str(pairs),
              layout=layout, n=3, n_meshes=2, n_views=2, train_batch=2, train_count=2,
              seed=5, fmr=True)
    port = DS.generate_datasets(DS.DatasetConfig(
        **kw, corrupt=corrupt and DS.CorruptConfig(**corrupt)))
    jax_ = JDS.generate_datasets(JDS.DatasetConfig(
        **kw, corrupt=corrupt and JDS.CorruptConfig(**corrupt)))
    return port, jax_


@pytest.mark.parametrize("layout", ["indexed", "views"])
def test_generate_datasets_split_equals_jax(pairs, layout):
    (tr, te), (jtr, jte) = _loaders(pairs, layout=layout)
    for a, b in ((tr, jtr), (te, jte)):
        assert a.dataset.src_paths == b.dataset.src_paths
        assert a.dataset.tar_paths == b.dataset.tar_paths
        assert len(a) == len(b) and (a.batch_size, a.shuffle, a.drop_last) == (
            b.batch_size, b.shuffle, b.drop_last)
    assert len(te.dataset) == 1


@pytest.mark.parametrize("corrupt", [None, dict(noise_type="jitter", rot_mag=20.0)],
                         ids=["clean", "corrupted"])
def test_loader_batches_equal_jax_over_two_epochs(pairs, corrupt):
    """Shuffled single-pair batches in the DCP form, with and without the
    per-epoch corruption stream."""
    src, tar = DS.pair_lists_indexed(str(pairs), 2)
    tr = DS.Loader(DS.RegistrationPairs(src, tar, dcp=True,
                                        corrupt=corrupt and DS.CorruptConfig(**corrupt)),
                   1, seed=3)
    jtr = JDS.Loader(JDS.RegistrationPairs(src, tar, dcp=True,
                                           corrupt=corrupt and JDS.CorruptConfig(**corrupt)),
                     1, seed=3)
    for epoch in range(2):
        tr.set_epoch(epoch)
        jtr.set_epoch(epoch)
        got, want = list(tr), list(jtr)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            _equal(a, b)


def test_prefetch_loader_equals_loader_and_raises(pairs):
    (tr, _), (jtr, _) = _loaders(pairs)
    pre = DS.PrefetchLoader(tr, depth=1, device="cpu")
    for epoch in range(2):
        pre.set_epoch(epoch)
        jtr.set_epoch(epoch)
        got = list(pre)
        assert len(got) == len(pre) == 1
        for a, b in zip(got, list(jtr)):
            assert all(isinstance(v, torch.Tensor) for v in a.values())
            _equal(a, b)

    class Broken:
        def __iter__(self):
            yield {"x": np.zeros(2)}
            raise IOError("corrupt file")

    it = iter(DS.PrefetchLoader(Broken(), device="cpu"))
    assert torch.equal(next(it)["x"], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(IOError, match="corrupt file"):
        next(it)


def test_device_cache_equals_loader(pairs):
    (tr, te), _ = _loaders(pairs)
    tr2 = DS.Loader(DS.RegistrationPairs(*DS.pair_lists_indexed(str(pairs), 2), fmr=True),
                    1, shuffle=True, seed=9)
    for loader in (tr, te, tr2):
        cache = DS.maybe_device_cache(loader, device="cpu")
        assert isinstance(cache, DS.DeviceCache) and len(cache) == len(loader)
        for epoch in range(2):
            cache.set_epoch(epoch)
            loader.set_epoch(epoch)
            got, want = list(cache), list(loader)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                _equal(a, b)
        data, full, rem = cache.device_epoch(0)
        assert full.dtype == torch.int64 and rem is None
    (tr, _), _ = _loaders(pairs, corrupt=dict(noise_type="jitter"))
    assert DS.maybe_device_cache(tr, device="cpu") is tr  # corruption: never cached
    with pytest.raises(ValueError, match="corruption"):
        DS.DeviceCache(tr, device="cpu")
    assert DS.maybe_device_cache([1, 2], device="cpu") == [1, 2]
    (tr, _), _ = _loaders(pairs)
    assert DS.maybe_device_cache(tr, device="cpu", max_bytes=100) is tr


def test_device_cache_can_be_switched_off(pairs, monkeypatch):
    (tr, _), _ = _loaders(pairs)
    monkeypatch.setenv("ARRL_NO_DEVICE_CACHE", "1")
    assert DS.maybe_device_cache(tr, device="cpu") is tr


def test_companions_resolve_on_the_basename_only(tmp_path):
    """A directory named like the pattern must not redirect the companion
    lookups: both packages read the file's own normals and transform."""
    d = tmp_path / "sample_data"
    d.mkdir()
    rng = np.random.default_rng(1)
    src = sphere_cloud(40, rng, noise=0.01)
    for tag in ("src", "tar"):
        JO.write_obj(str(d / f"0_{tag}_sample.obj"), src)
        JO.write_obj(str(d / f"0_{tag}_sample_normals.obj"), np.ones((40, 3), np.float32))
        src.tofile(str(d / f"0_{tag}_sample_neigh.bin"))
    np.concatenate([np.eye(3), np.ones((3, 1))], 1).tofile(str(d / "0_transform.bin"))
    args = (str(d / "0_src_sample.obj"), str(d / "0_tar_sample.obj"))
    assert DS._normals_path(args[0]) == JDS._normals_path(args[0])
    assert DS._transform_path(args[1]) == JDS._transform_path(args[1])
    got, want = DS.load_pair(*args), JDS.load_pair(*args)
    _equal(got, want)
    assert np.all(got["normals_src"] == 1) and np.allclose(got["T"], 1.0)


def _transform_cases():
    pts = sphere_cloud(50, np.random.default_rng(0), noise=0.02)
    return {
        "so3_exp": lambda m, r: m._so3_exp(r.standard_normal(3)),
        "so3_exp_small": lambda m, r: m._so3_exp(r.standard_normal(3) * 1e-9),
        "se3_exp": lambda m, r: m._se3_exp(r.standard_normal(6)),
        "transform_points": lambda m, r: m.transform_points(m._se3_exp(r.standard_normal(6)), pts),
        "on_unit_sphere": lambda m, r: m.on_unit_sphere(pts + 1, zero_mean=True),
        "on_unit_cube": lambda m, r: m.on_unit_cube(pts * 3),
        "resample": lambda m, r: m.resample(pts, 137, r),
        "random_jitter": lambda m, r: m.random_jitter(pts, r),
        "random_translate": lambda m, r: m.random_translate(pts, r, mag=0.5),
        "random_rotator": lambda m, r: m.random_rotator(pts, r, mag=1.0),
        "random_rotator_z": lambda m, r: m.random_rotator_z(pts, r),
        "random_twist": lambda m, r: m.random_twist(r, 0.7, mag_randomly=True),
        "random_crop": lambda m, r: m.random_crop(pts, r, keep_ratio=0.6),
        "random_transform_se3": lambda m, r: m.random_transform_se3(pts, r, 0.8),
    }


@pytest.mark.parametrize("name", list(_transform_cases()))
def test_transforms_equal_jax(name):
    fn = _transform_cases()[name]
    got, want = fn(T, np.random.default_rng(11)), fn(JT, np.random.default_rng(11))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b), name


def test_estimated_normals_on_device_match_jax(pairs, tmp_path):
    """A bare pair with ``estimate_normals``: the port computes the PCA
    normals on the given device; |n . n'| within 1e-4 of 1 against JAX's
    (sign and basis of an eigenvector are free)."""
    for tag in ("src", "tar"):
        shutil.copy(pairs / f"2_{tag}_sample.obj", tmp_path / f"0_{tag}_sample.obj")
        shutil.copy(pairs / f"2_{tag}_sample_neigh.bin", tmp_path / f"0_{tag}_sample_neigh.bin")
    args = (str(tmp_path / "0_src_sample.obj"), str(tmp_path / "0_tar_sample.obj"))
    got = DS.load_pair(*args, estimate_normals=True, device="cpu")
    want = JDS.load_pair(*args, estimate_normals=True)
    for k in ("normals_src", "normals_tar"):
        dots = np.abs((got[k] * want[k]).sum(-1))
        assert dots.min() > 1 - 1e-4, (k, dots.min())
    got.pop("normals_src"), got.pop("normals_tar")
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    assert os.path.exists(args[0])
