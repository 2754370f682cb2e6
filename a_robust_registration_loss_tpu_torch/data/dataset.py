"""The registration-pair dataset: dict contract, adapters, loaders, and a
dataset cache on the card.

Port of ``a_robust_registration_loss_tpu/data/dataset.py``. The on-disk
artifact set is the reference's: ``{stem}_src_sample.obj`` /
``{stem}_tar_sample.obj`` point clouds, ``*_sample_normals.obj``
companions, ``*_neigh.bin`` float32 neighbour buffers and
``*transform*.bin`` float64 (3, 4) ground-truth transforms. Items and
batches are numpy dicts, as in the JAX package, with the same keys and the
same values; the shuffle and corruption streams are its numpy streams
(``default_rng((seed, epoch))``, ``default_rng((seed, epoch, i))``), so one
seed gives the same batches on both sides.

Conventions (row vectors: ``tar ~= src @ R + T`` in the centred frames):
``R``/``T`` map the centred source onto the centred target, ``R_inv`` /
``T_inv`` are their true inverse, ``igt = [[R, -R @ T], [0, 1]]`` (column
convention, centred target -> centred source), ``centers`` is the mean of
the centred target (about 0, the reference's quirk, kept because it is the
line sampler's centre). The DCP adapter transposes the rotations to column
convention; the FMR adapter truncates both clouds to the common length.

Two ways to the card:

- ``PrefetchLoader(loader, device=...)`` loads the next batch on a thread
  while the card runs the current step, pins it and copies it with
  ``non_blocking=True``, so a streamed batch costs the stream no wait;
- ``DeviceCache`` copies the whole collated dataset to the card once, one
  tensor per key, and gathers each batch there with ``index_select``: the
  trainer's batches are already on the card, and no host copy or wait
  happens per batch. ``maybe_device_cache`` picks it where it applies.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from a_robust_registration_loss_tpu_torch import _device
from a_robust_registration_loss_tpu_torch.data import objio
from a_robust_registration_loss_tpu_torch.data import transforms as T


def bounding_box_corners_np(v):
    """8 AABB corners, the order of ``ops.geometry.bounding_box_corners``
    (corner 0 = max, corner 7 = min; diagonal = ||c0 - c7||)."""
    mx, my, mz = v.max(0)
    nx, ny, nz = v.min(0)
    return np.array(
        [[mx, my, mz], [mx, my, nz], [mx, ny, mz], [mx, ny, nz],
         [nx, my, mz], [nx, my, nz], [nx, ny, mz], [nx, ny, nz]],
        np.float32,
    )


def _sibling(path: str, old: str, new: str) -> str:
    """Companion-file naming applied to the basename only: the reference
    replaces on the whole path, which finds the wrong file when a directory
    component holds the pattern (``sample_data/0_src_sample.obj`` would look
    for normals in ``sample_normals_data/``)."""
    head, base = os.path.split(path)
    return os.path.join(head, base.replace(old, new, 1))


def _normals_path(sample_path: str) -> str:
    return _sibling(sample_path, "sample", "sample_normals")


def _neigh_path(sample_path: str) -> str:
    return _sibling(sample_path, ".obj", "_neigh.bin")


def _transform_path(tar_sample_path: str) -> str:
    return _sibling(_sibling(tar_sample_path, "tar_sample", "transform"),
                    ".obj", ".bin")


def load_pair_plain(src_path: str, tar_path: str,
                    estimate_normals: bool = False, device=None) -> dict:
    """One registration pair as the reference's plain dict contract, before
    the DCP / FMR adapters; every value a float32 numpy array.

    A missing ``*_sample_normals.obj`` companion gives zero normals, or,
    with ``estimate_normals``, PCA estimates computed on ``device`` (the
    card unless "cpu"); a missing ``*transform*.bin`` gives the identity
    (ground truth only feeds the monitors, never the unsupervised losses).
    The reference crashes on both."""
    v_src, _ = objio.read_obj(src_path)
    v_tar, _ = objio.read_obj(tar_path)

    def _read_normals(path, verts):
        if os.path.exists(path):
            nrm, _ = objio.read_obj(path)
            return nrm
        if estimate_normals:
            from a_robust_registration_loss_tpu_torch.ops import geometry as G

            dev = _device.resolve(device)
            return G.estimate_normals(torch.as_tensor(verts).to(dev)).cpu().numpy()
        return np.zeros((verts.shape[0], 3), np.float32)

    normals_src = _read_normals(_normals_path(src_path), v_src)
    normals_tar = _read_normals(_normals_path(tar_path), v_tar)
    neighs_src = np.fromfile(_neigh_path(src_path), np.float32).reshape(-1, 3)
    neighs_tar = np.fromfile(_neigh_path(tar_path), np.float32).reshape(-1, 3)

    c_src = v_src.mean(0)
    c_tar = v_tar.mean(0)
    v_src = v_src - c_src
    v_tar = v_tar - c_tar
    neighs_src = neighs_src - c_src
    neighs_tar = neighs_tar - c_tar
    tar_box = bounding_box_corners_np(v_tar)

    tpath = _transform_path(tar_path)
    if os.path.exists(tpath):
        gt = np.fromfile(tpath, np.float64).reshape(3, 4)
    else:
        gt = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    R = gt[:3, :3].astype(np.float64)
    # the translation in the centred frames: tar - c_tar = (src - c_src) @ R + T'
    T_ = gt[:3, 3] + (-c_tar + c_src @ R)

    igt = np.eye(4)
    igt[:3, :3] = R
    igt[:3, 3] = -R @ T_

    return {
        "points_tar_sample": v_tar.astype(np.float32),
        "points_src_sample": v_src.astype(np.float32),
        "normals_tar": normals_tar.astype(np.float32),
        "normals_src": normals_src.astype(np.float32),
        "tar_box": tar_box,
        "centers": v_tar.mean(0).astype(np.float32),
        "R": R.astype(np.float32),
        "T": T_.astype(np.float32),
        "R_inv": R.T.astype(np.float32),
        "T_inv": (-R @ T_).astype(np.float32),
        "points_based_neighs_src": neighs_src.astype(np.float32),
        "points_based_neighs_tar": neighs_tar.astype(np.float32),
        "igt": igt.astype(np.float32),
    }


def apply_adapters(data: dict, dcp: bool = False, fmr: bool = False) -> dict:
    """The DCP (column-convention rotations) and FMR (common-length
    truncation) adapters over the plain dict."""
    data = dict(data)
    if dcp:
        data["R"] = data["R"].T.copy()
        data["R_inv"] = data["R_inv"].T.copy()
        igt_d = data["igt"].copy()
        igt_d[:3, :3] = igt_d[:3, :3].T
        data["igt"] = igt_d
    if fmr:
        n = min(data["points_src_sample"].shape[0],
                data["points_tar_sample"].shape[0])
        data["points_tar_sample"] = data["points_tar_sample"][:n]
        data["points_src_sample"] = data["points_src_sample"][:n]
    return data


def load_pair(src_path: str, tar_path: str, dcp: bool = False,
              fmr: bool = False, estimate_normals: bool = False, device=None) -> dict:
    """``load_pair_plain`` + adapters."""
    return apply_adapters(load_pair_plain(src_path, tar_path, estimate_normals, device),
                          dcp, fmr)


@dataclasses.dataclass(frozen=True)
class CorruptConfig:
    """Data corruption behind the reference RPM CLI's --num_points /
    --noise_type / --rot_mag / --trans_mag / --partial flags, applied per
    item on the host with an explicit per-epoch generator, on the plain
    contract (before the adapters).

    - ``num_points``: a random subsample of both clouds (+ normals).
    - ``noise_type``: "clean" | "jitter" (clipped Gaussian on the source
      cloud and its neighbour buffer) | "crop" (a planar partial view of
      the source; the neighbour triples are cropped by their seed point
      under the same plane).
    - ``rot_mag`` (degrees) / ``trans_mag``: an extra random SE(3) applied
      to the source cloud, normals and neighbours, with the ground truth
      updated so the pair stays consistent.
    """

    num_points: Optional[int] = None
    noise_type: str = "clean"
    jitter_scale: float = 0.01
    jitter_clip: float = 0.05
    rot_mag: float = 0.0
    trans_mag: float = 0.0
    partial_keep: float = 0.7
    seed: int = 0


def corrupt_pair(data: dict, cfg: CorruptConfig, rng) -> dict:
    """Apply ``cfg`` to one plain-contract item. Output shapes depend only
    on the input shapes and ``cfg``, so the items of a batch collate."""
    data = dict(data)
    src = data["points_src_sample"]
    tar = data["points_tar_sample"]

    if cfg.num_points:
        for tag, cloud in (("src", src), ("tar", tar)):
            n = min(cfg.num_points, cloud.shape[0])
            idx = np.sort(rng.choice(cloud.shape[0], size=n, replace=False))
            data[f"points_{tag}_sample"] = cloud[idx]
            data[f"normals_{tag}"] = data[f"normals_{tag}"][idx]
        src = data["points_src_sample"]

    if cfg.noise_type == "jitter":
        data["points_src_sample"], _ = T.random_jitter(
            src, rng, scale=cfg.jitter_scale, clip=cfg.jitter_clip)
        data["points_based_neighs_src"], _ = T.random_jitter(
            data["points_based_neighs_src"], rng, scale=cfg.jitter_scale,
            clip=cfg.jitter_clip)
    elif cfg.noise_type == "crop":
        cropped, idx, direction = T.random_crop(src, rng, keep_ratio=cfg.partial_keep)
        data["points_src_sample"] = cropped
        data["normals_src"] = data["normals_src"][idx]
        neis = data["points_based_neighs_src"].reshape(-1, 3, 3)
        seeds = neis[:, 0, :]
        k = max(1, int(round(seeds.shape[0] * cfg.partial_keep)))
        proj = seeds.astype(np.float64) @ direction.astype(np.float64)
        keep = np.sort(np.argsort(-proj, kind="stable")[:k])
        data["points_based_neighs_src"] = neis[keep].reshape(-1, 3)

    if cfg.rot_mag > 0.0 or cfg.trans_mag > 0.0:
        _, Rg = T.random_rotator(np.zeros((1, 3), np.float32), rng,
                                 mag=np.deg2rad(cfg.rot_mag))
        Tg = np.zeros(3)
        if cfg.trans_mag > 0.0:
            Tg = rng.standard_normal(3)
            Tg = Tg / np.linalg.norm(Tg) * rng.random() * cfg.trans_mag
        src = data["points_src_sample"].astype(np.float64)
        data["points_src_sample"] = (src @ Rg + Tg).astype(np.float32)
        data["normals_src"] = (data["normals_src"].astype(np.float64) @ Rg).astype(np.float32)
        neis = data["points_based_neighs_src"].astype(np.float64)
        data["points_based_neighs_src"] = (neis @ Rg + Tg).astype(np.float32)
        # row convention, tar = src' @ R' + T' with src' = src @ Rg + Tg:
        # R' = Rg^T R, T' = T - Tg @ R'
        R2 = Rg.T @ data["R"].astype(np.float64)
        T2 = data["T"].astype(np.float64) - Tg @ R2
        data["R"] = R2.astype(np.float32)
        data["T"] = T2.astype(np.float32)
        data["R_inv"] = R2.T.astype(np.float32)
        data["T_inv"] = (-R2 @ T2).astype(np.float32)
        igt = np.eye(4)
        igt[:3, :3] = R2
        igt[:3, 3] = -R2 @ T2
        data["igt"] = igt.astype(np.float32)
    return data


class RegistrationPairs:
    """Indexable pair dataset over path lists. ``cache`` keeps parsed pairs
    in memory after their first load (the files are static). Corruption
    draws are a pure function of (corrupt.seed, epoch, index): fresh every
    epoch, reproducible across a kill and resume. ``device`` is where
    ``estimate_normals`` runs."""

    def __init__(self, src_paths: Sequence[str], tar_paths: Sequence[str],
                 dcp: bool = False, fmr: bool = False,
                 estimate_normals: bool = False, cache: bool = True,
                 corrupt: Optional[CorruptConfig] = None, device=None):
        if len(src_paths) != len(tar_paths):
            raise ValueError("src/tar path lists differ in length")
        self.src_paths = list(src_paths)
        self.tar_paths = list(tar_paths)
        self.dcp = dcp
        self.fmr = fmr
        self.estimate_normals = estimate_normals
        self.corrupt = corrupt
        self.device = device
        self.epoch = 0
        self._cache: Optional[dict] = {} if cache else None

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.src_paths)

    def _plain(self, i: int) -> dict:
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        item = load_pair_plain(self.src_paths[i], self.tar_paths[i],
                               self.estimate_normals, self.device)
        if self._cache is not None:
            self._cache[i] = item
        return item

    def __getitem__(self, i: int) -> dict:
        item = self._plain(i)
        if self.corrupt is not None:
            rng = np.random.default_rng((self.corrupt.seed, self.epoch, i))
            item = corrupt_pair(item, self.corrupt, rng)
        return apply_adapters(item, self.dcp, self.fmr)


def collate(items: List[dict]) -> dict:
    """Stack per-pair dicts into a batch dict (leading batch axis); the
    pairs of a batch must share shapes."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class Loader:
    """Deterministic batching iterator: shuffle + drop_last as the
    reference's DataLoaders, seeded explicitly and epoch-indexed. The
    trainer pins the epoch with ``set_epoch``, so batch order is a pure
    function of (seed, epoch)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        self.epoch += 1
        for s in range(0, n, self.batch_size):
            idx = order[s : s + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield collate([self.dataset[int(i)] for i in idx])


def _to_device(x, dev: torch.device):
    """A numpy array or host tensor -> a tensor on ``dev``; to a card
    through pinned memory with ``non_blocking=True``, which queues the copy
    without a stream wait."""
    x = torch.as_tensor(x)
    if dev.type != "cuda":
        return x.to(dev)
    return x.pin_memory().to(dev, non_blocking=True)


class PrefetchLoader:
    """Background-thread prefetch around any batch iterable: the next batch
    is loaded (OBJ parsing, neighbour bins) while the card runs the current
    step, ``depth`` batches ahead. Batches are yielded as tensors on
    ``device`` (the card unless "cpu"), copied to a card from pinned memory
    without a stream wait. An exception in the worker reaches the
    consumer."""

    def __init__(self, loader, depth: int = 2, device=None):
        self.loader = loader
        self.depth = depth
        self.device = _device.resolve(device)

    def set_epoch(self, epoch: int):
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        error: list = []
        pin = self.device.type == "cuda"

        def worker():
            try:
                for batch in self.loader:
                    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
                    if pin:
                        batch = {k: v.pin_memory() for k, v in batch.items()}
                    q.put(batch)
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                t.join()
                if error:
                    raise error[0]
                return
            yield {k: v.to(self.device, non_blocking=pin) for k, v in item.items()}


class DeviceCache:
    """The whole dataset on the card: every item of the wrapped ``Loader``'s
    dataset is collated once on the host and copied to ``device`` once, one
    tensor per key; each batch is then gathered there with
    ``index_select``. The shuffle is the Loader's own stream (a pure
    function of (seed, epoch)), so the batches, and every loss, equal the
    streaming path's bit for bit.

    An epoch costs one copy of its index plan (through pinned memory,
    without a stream wait), made when iteration starts; a batch costs no
    host copy and no wait. Epoch-varying corruption is host work by design,
    so a corrupted dataset cannot be cached (``ValueError``)."""

    def __init__(self, loader: "Loader", device=None):
        ds = loader.dataset
        if getattr(ds, "corrupt", None) is not None:
            raise ValueError("DeviceCache cannot cache epoch-varying "
                             "corruption; use the streaming Loader")
        items = [ds[i] for i in range(len(ds))]
        if not items:
            raise ValueError("empty dataset")
        self.device = _device.resolve(device)
        self.data = {k: _to_device(v, self.device) for k, v in collate(items).items()}
        self.n = len(items)
        self.batch_size = loader.batch_size
        self.shuffle = loader.shuffle
        self.drop_last = loader.drop_last
        self.seed = loader.seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        n, b = self.n, self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def _order(self, epoch: int):
        order = np.arange(self.n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(self.n)
        return order

    def device_epoch(self, epoch: int):
        """(data, full_idx (n_full, B) int64, rem_idx (r,) int64 or None),
        the index tensors on the card: the epoch's plan. A non-empty
        remainder (drop_last=False, n % B != 0) is one smaller batch."""
        order = self._order(epoch)
        n_full = self.n // self.batch_size
        full = order[: n_full * self.batch_size].reshape(n_full, self.batch_size)
        rem = order[n_full * self.batch_size:]
        rem = None if self.drop_last or rem.size == 0 else _to_device(rem, self.device)
        return self.data, _to_device(full, self.device), rem

    def gather(self, idx):
        """One batch by row indices (a tensor on the card)."""
        return {k: v.index_select(0, idx) for k, v in self.data.items()}

    def _batches(self, full, rem):
        for row in full:
            yield self.gather(row)
        if rem is not None:
            yield self.gather(rem)

    def next_epoch(self):
        """``device_epoch`` of the current epoch, which then advances, as
        iterating does: the plan of ``train/harness.py``'s scanned epoch."""
        plan = self.device_epoch(self.epoch)
        self.epoch += 1
        return plan

    def __iter__(self):
        # not a generator: the epoch's index plan is copied when iteration
        # starts, not on the first batch
        _, full, rem = self.next_epoch()
        return self._batches(full, rem)


def maybe_device_cache(loader, device=None, max_bytes=2 << 30):
    """Wrap a ``Loader`` in a ``DeviceCache`` on ``device`` when its dataset
    is cacheable: no epoch-varying corruption, not empty, and at most
    ``max_bytes`` in all; return the loader unchanged otherwise (also any
    other iterable). ``ARRL_NO_DEVICE_CACHE=1`` forces the streaming
    path."""
    if os.environ.get("ARRL_NO_DEVICE_CACHE") == "1":
        return loader
    if not isinstance(loader, Loader):
        return loader
    ds = loader.dataset
    if getattr(ds, "corrupt", None) is not None or not len(ds):
        return loader
    item_bytes = sum(np.asarray(v).nbytes for v in ds[0].values())
    if item_bytes * len(ds) > max_bytes:
        return loader
    try:
        return DeviceCache(loader, device)
    except (ValueError, TypeError):
        return loader


def pair_lists_views(data_path: str, n_meshes: int, n_views: int):
    """The ``src_sample_{mesh}_{view}.obj`` layout."""
    src, tar = [], []
    for m in range(n_meshes):
        for v in range(n_views):
            src.append(os.path.join(data_path, f"src_sample_{m}_{v}.obj"))
            tar.append(os.path.join(data_path, f"tar_sample_{m}_{v}.obj"))
    return src, tar


def pair_lists_indexed(data_path: str, n: int):
    """The ``{i}_src_sample.obj`` layout."""
    src = [os.path.join(data_path, f"{i}_src_sample.obj") for i in range(n)]
    tar = [os.path.join(data_path, f"{i}_tar_sample.obj") for i in range(n)]
    return src, tar


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    data_path: str = ""
    layout: str = "indexed"        # "indexed" | "views"
    n: int = 4                     # indexed: pair count
    n_meshes: int = 110            # views layout (the reference's human
    n_views: int = 50              #   dataset)
    train_batch: int = 4
    test_batch: int = 1
    train_count: Optional[int] = None   # cap on training pairs
    test_count: Optional[int] = None
    seed: int = 0
    dcp: bool = False
    fmr: bool = False
    estimate_normals: bool = False
    cache: bool = True
    corrupt: Optional[CorruptConfig] = None   # train AND test loaders


def generate_datasets(cfg: DatasetConfig, device=None):
    """(train Loader, test Loader) over the pairs whose both files exist:
    the first ``train_count`` pairs train, the rest test (all of them, up
    to ``test_count``, when none is left). ``device`` is where
    ``estimate_normals`` runs."""
    if cfg.layout == "views":
        src, tar = pair_lists_views(cfg.data_path, cfg.n_meshes, cfg.n_views)
    else:
        src, tar = pair_lists_indexed(cfg.data_path, cfg.n)
    keep = [i for i, s in enumerate(src)
            if os.path.exists(s) and os.path.exists(tar[i])]
    src = [src[i] for i in keep]
    tar = [tar[i] for i in keep]
    n_train = cfg.train_count if cfg.train_count is not None else len(src)
    common = dict(dcp=cfg.dcp, fmr=cfg.fmr, estimate_normals=cfg.estimate_normals,
                  cache=cfg.cache, corrupt=cfg.corrupt, device=device)
    train_ds = RegistrationPairs(src[:n_train], tar[:n_train], **common)
    test_src = src[n_train:] or src[:cfg.test_count or len(src)]
    test_tar = tar[n_train:] or tar[:cfg.test_count or len(tar)]
    test_ds = RegistrationPairs(test_src, test_tar, **common)
    train = Loader(train_ds, cfg.train_batch, shuffle=True, drop_last=True,
                   seed=cfg.seed)
    test = Loader(test_ds, cfg.test_batch, shuffle=False, drop_last=False,
                  seed=cfg.seed)
    return train, test
