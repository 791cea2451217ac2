"""ModelNet40 pre-voxelized loader + synthetic fallback.

Reference semantics: dataLoader at src/dataset_loader/modelnet_dataset.py:5-91
— sharded .npy triples ({i}Full/Class/Inst.npy) under
``32to64_4rot_64sqr/{train,test}`` (30 train shards, 5 test shards), all in
RAM, index-shuffled epochs. Additions: optional process sharding
(each host loads every Nth shard — the multi-host input pipeline), memory-
mapped loads, and a seeded RNG instead of global np.random.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class ModelNetLoader:
    """Host-side loader for pre-voxelized ModelNet shards.

    ``getNextBatch(batchSize)`` -> dict with ``input_images`` (B, 64, 64, 64[,1]),
    ``class_list`` (B, 40), ``inst_list`` — matching the reference batch dict
    (modelnet_dataset.py:86-91). Exposes ``epoch`` / ``batchStart`` /
    ``dataLength`` for the trainer's progress display.
    """

    def __init__(
        self,
        data_path: str,
        train_or_test: str = "train",
        partial_num: int | None = 30,
        process_index: int = 0,
        process_count: int = 1,
        seed: int = 0,
        mmap: bool = True,
    ):
        """``partial_num``: number of train shards to read (reference
        default 30, modelnet_dataset.py:24); ``None`` = every ``*Full.npy``
        shard present on disk (subsets / fixtures)."""
        self.epoch = 0
        self.batchStart = 0
        self._rng = np.random.default_rng(seed + process_index)
        split = "train" if train_or_test == "train" else "test"
        base = os.path.join(data_path, "32to64_4rot_64sqr", split)
        if partial_num is None:
            import glob as _glob

            n_shards = len(_glob.glob(os.path.join(base, "*Full.npy")))
            if n_shards == 0:
                raise FileNotFoundError(f"no *Full.npy shards under {base}")
        else:
            n_shards = partial_num if split == "train" else 5
        mmap_mode = "r" if mmap else None

        vox, cls, inst = [], [], []
        for i in range(process_index, n_shards, process_count):
            vox.append(np.load(os.path.join(base, f"{i}Full.npy"), mmap_mode=mmap_mode))
            cls.append(np.load(os.path.join(base, f"{i}Class.npy"), mmap_mode=mmap_mode))
            inst.append(np.load(os.path.join(base, f"{i}Inst.npy"), mmap_mode=mmap_mode))
        self._vox = np.concatenate(vox, axis=0)
        self._cls = np.concatenate(cls, axis=0)
        self._inst = np.concatenate(inst, axis=0)
        self.dataLength = len(self._vox)
        self._idx = np.arange(self.dataLength)
        self._shuffle()

    def _shuffle(self):
        self._rng.shuffle(self._idx)
        self.batchStart = 0

    def getNextBatch(self, batchSize: int = 32) -> Dict[str, np.ndarray]:
        if self.batchStart + batchSize > self.dataLength:
            self.epoch += 1
            self._shuffle()
        sel = self._idx[self.batchStart : self.batchStart + batchSize]
        self.batchStart += batchSize
        vox = np.ascontiguousarray(self._vox[sel]).astype(np.float32)
        if vox.ndim == 4:
            vox = vox[..., None]
        return {
            "input_images": vox,
            "class_list": np.ascontiguousarray(self._cls[sel]).astype(np.float32),
            "inst_list": np.ascontiguousarray(self._inst[sel]).astype(np.float32),
        }


def _jitter_zoom(grid: np.ndarray, factors) -> np.ndarray:
    """Anisotropic nearest-neighbour rescale about the grid center (the
    per-sample jitter for structural instance shapes). ``factors`` ~1."""
    d = grid.shape[0]
    c = (d - 1) / 2.0
    out_idx = [
        np.clip(np.round((np.arange(d) - c) / f + c), 0, d - 1).astype(int)
        for f in np.asarray(factors, np.float64)
    ]
    return grid[np.ix_(out_idx[0], out_idx[1], out_idx[2])]


class SyntheticVoxelLoader:
    """Drop-in ModelNetLoader replacement producing procedural shapes for
    tests, benches and dataset-free quality runs. Deterministic under seed.

    Class-informative by construction (the quality-parity requirement): each
    class owns a shape family (8 families) AND class-specific canonical
    half-extents; each instance perturbs those deterministically; each sample
    adds small jitter plus one of 4 yaw rotations — mirroring the reference
    dataset's ``4rot`` augmentation (modelnet_dataset.py:33). Nearest-prior
    classification and anytime correction are therefore learnable, unlike a
    label-independent shape soup. Voxels are generated once at construction
    (the reference loader also holds everything in RAM)."""

    def __init__(
        self,
        num_samples: int = 512,
        dim: int = 64,
        num_classes: int = 40,
        num_inst: int = 10,
        seed: int = 0,
        inst_spread: float = 0.15,
        structural_inst: bool = False,
    ):
        """``inst_spread``: half-width of the per-instance canonical-extent
        multiplier range (0.15 -> U(0.85, 1.15)). Wider spreads make the
        instance identity recoverable from a single silhouette, mirroring
        how distinct CAD models differ structurally; the default preserves
        the distribution of every committed r1/r2 quality run.

        ``structural_inst=True`` replaces the analytic families with the
        procedural part-based CAD stand-ins (data/instances.py, voxelized
        through data/voxelize.py): instances of a class then differ in
        STRUCTURE (leg count, shade type, wing sweep, ...) like real CAD
        sets (nolbo.py:166-181), not just scale — the r3-measured
        scale-only ceiling on instance accuracy does not apply."""
        self.epoch = 0
        self.batchStart = 0
        self.dataLength = num_samples
        self._dim = dim
        self._num_classes = num_classes
        self._num_inst = num_inst
        self._structural = structural_inst
        rng = np.random.default_rng(seed)
        self._labels = rng.integers(0, num_classes, num_samples)
        self._insts = rng.integers(0, num_inst, num_samples)
        # class canonical extents: one draw per class from a class-keyed
        # stream, shared by every loader instance with any seed
        class_rng = np.random.default_rng(12345)
        class_params = class_rng.uniform(0.18, 0.42, size=(num_classes, 3))
        inst_rng = np.random.default_rng(54321)
        inst_scale = inst_rng.uniform(
            1.0 - inst_spread, 1.0 + inst_spread, size=(num_classes, num_inst, 3)
        )
        jitter = rng.uniform(0.95, 1.05, size=(num_samples, 3))
        self._params = (
            class_params[self._labels] * inst_scale[self._labels, self._insts] * jitter
        ).astype(np.float32)
        self._rots = rng.integers(0, 4, num_samples)
        self._idx = np.arange(num_samples)
        self._rng = rng
        coords = (np.arange(dim) + 0.5) / dim - 0.5
        self._grid = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"), -1)
        self._cache = np.stack(
            [self._generate(i) for i in range(num_samples)]
        ).astype(bool)

    def _generate(self, i: int) -> np.ndarray:
        """Occupancy for sample i: family = class % 8, rotated by the
        sample's yaw quarter-turn. In ``structural_inst`` mode the base
        shape is the (class, instance) part-based CAD stand-in
        (data/instances.py) with per-sample anisotropic scale jitter —
        instance identity is then structural, like real CAD sets."""
        label = int(self._labels[i])
        if self._structural:
            from anytime3d_tpu.data.instances import instance_grid

            base = instance_grid(label, int(self._insts[i]), self._dim)
            occ = _jitter_zoom(base, self._params[i] / self._params[i].mean())
            k = int(self._rots[i])
            if k:
                occ = np.rot90(occ, k=k, axes=(0, 2)).copy()
            return occ.astype(np.float32)
        a, b, c = self._params[i]
        g = self._grid
        x, y, z = g[..., 0], g[..., 1], g[..., 2]
        family = label % 8
        if family == 0:  # ellipsoid
            occ = (x / a) ** 2 + (y / b) ** 2 + (z / c) ** 2 <= 1.0
        elif family == 1:  # box
            occ = (np.abs(x) <= a) & (np.abs(y) <= b) & (np.abs(z) <= c)
        elif family == 2:  # y-axis elliptic cylinder
            occ = ((x / a) ** 2 + (z / c) ** 2 <= 1.0) & (np.abs(y) <= b)
        elif family == 3:  # hollow box (shell)
            outer = (np.abs(x) <= a) & (np.abs(y) <= b) & (np.abs(z) <= c)
            inner = (
                (np.abs(x) <= 0.6 * a) & (np.abs(y) <= 0.6 * b) & (np.abs(z) <= 0.6 * c)
            )
            occ = outer & ~inner
        elif family == 4:  # three-axis cross of slabs
            t = 0.35
            sx = (np.abs(x) <= a) & (np.abs(y) <= t * b) & (np.abs(z) <= t * c)
            sy = (np.abs(x) <= t * a) & (np.abs(y) <= b) & (np.abs(z) <= t * c)
            sz = (np.abs(x) <= t * a) & (np.abs(y) <= t * b) & (np.abs(z) <= c)
            occ = sx | sy | sz
        elif family == 5:  # wedge/pyramid tapering upward in y
            t = np.clip((b - y) / (2.0 * b), 0.0, 1.0)
            occ = (np.abs(x) <= a * t) & (np.abs(z) <= c * t) & (np.abs(y) <= b)
        elif family == 6:  # torus about y
            ring = np.sqrt(x**2 + z**2) - a
            occ = ring**2 + (y / max(b, 1e-3) * 0.4 * a) ** 2 <= (0.4 * a) ** 2
        else:  # capsule along y
            r = 0.5 * (a + c) * 0.6
            seg = np.clip(y, -b + r, b - r)
            occ = x**2 + (y - seg) ** 2 + z**2 <= r**2
        occ = occ.astype(np.float32)
        k = int(self._rots[i])
        if k:
            occ = np.rot90(occ, k=k, axes=(0, 2)).copy()
        return occ

    def _make(self, i: int) -> np.ndarray:
        return self._cache[i].astype(np.float32)

    def getNextBatch(self, batchSize: int = 32) -> Dict[str, np.ndarray]:
        if self.batchStart + batchSize > self.dataLength:
            self.epoch += 1
            self._rng.shuffle(self._idx)
            self.batchStart = 0
        sel = self._idx[self.batchStart : self.batchStart + batchSize]
        self.batchStart += batchSize
        vox = self._cache[sel].astype(np.float32)[..., None]
        cls = np.eye(self._num_classes, dtype=np.float32)[self._labels[sel]]
        inst = np.eye(self._num_inst, dtype=np.float32)[self._insts[sel]]
        return {"input_images": vox, "class_list": cls, "inst_list": inst}


class SyntheticImageObjectLoader(SyntheticVoxelLoader):
    """Pascal-style synthetic loader: renders each procedural shape to an
    image (orthographic max-projection at a per-sample azimuth) and returns
    the reference single-object tuple (inst, cls, sin, cos, images, voxels)
    — the same contract as Pascal3DSingleObjectLoader.getNextBatch
    (pascal3D.py:277-283), so image->shape configs run end-to-end without a
    dataset. Any ``imageSize`` works, enabling the multi-scale schedule."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dataStart = 0  # pascal-style progress attribute
        self._azimuths = np.random.default_rng(kwargs.get("seed", 0) + 1).uniform(
            -np.pi, np.pi, self.dataLength
        )
        # (sample, size) -> uint8 mono render. Azimuth is fixed per sample,
        # so renders are deterministic and cacheable — after one epoch the
        # host render cost leaves the training critical path entirely
        # (~54 MB at 4096 samples x two scales).
        self._render_cache: Dict = {}

    def _render(self, vox: np.ndarray, azimuth: float, image_size) -> np.ndarray:
        """Rotate about the vertical axis (nearest-neighbour) then project.

        Shading (default on, ``self.render_shaded``): voxel brightness rises
        along the object's CANONICAL +x axis (0.35 -> 1.0), so the projected
        image reveals which way the object faces. A bare silhouette of these
        (mirror-symmetric) shapes determines azimuth only mod pi — the
        analytic floor of that ambiguity under the detector eval is
        (0.5*pi)/3 ~ 0.52 rad, exactly the flat ori-MAE plateau measured in
        r3 (VERDICT missing #3/weak table; detector_*.json) — so without a
        shading cue the orientation head CANNOT beat ~0.5 rad on this
        curriculum, regardless of architecture or loss."""
        d = vox.shape[0]
        c, s = np.cos(azimuth), np.sin(azimuth)
        idx = np.arange(d) - d / 2 + 0.5
        gx, gz = np.meshgrid(idx, idx, indexing="ij")
        sx = np.clip(np.round(c * gx - s * gz + d / 2 - 0.5), 0, d - 1).astype(int)
        sz = np.clip(np.round(s * gx + c * gz + d / 2 - 0.5), 0, d - 1).astype(int)
        # advanced indexing with a slice between the index arrays puts the
        # broadcast (x_out, z_out) dims first: rot is (x_out, z_out, y)
        rot = vox[sx, :, sz]
        if getattr(self, "render_shaded", True):
            w = (0.35 + 0.65 * sx / max(d - 1, 1)).astype(np.float32)
            rot = rot * w[:, :, None]
        img = rot.max(axis=2).T.astype(np.float32)  # (rows=y, cols=x)
        out_c, out_r = image_size
        ys = (np.arange(out_r) * d // out_r).astype(int)
        xs = (np.arange(out_c) * d // out_c).astype(int)
        img = img[ys][:, xs]
        return np.stack([img] * 3, axis=-1)

    def _render_cached(self, i: int, vox: np.ndarray, azimuth: float,
                       image_size) -> np.ndarray:
        mono = self._render_cache.get((i, image_size))
        if mono is None:
            mono = (self._render(vox, azimuth, image_size)[..., 0] * 255).astype(
                np.uint8
            )
            self._render_cache[(i, image_size)] = mono
        img = mono.astype(np.float32) / 255.0
        return np.stack([img] * 3, axis=-1)

    def getNextBatch(self, batchSizeof3DShape: int = 32, imageSize=(64, 64),
                     augmentation=None):
        if self.batchStart + batchSizeof3DShape > self.dataLength:
            self.epoch += 1
            self._rng.shuffle(self._idx)
            self.batchStart = 0
        sel = self._idx[self.batchStart : self.batchStart + batchSizeof3DShape]
        self.batchStart += batchSizeof3DShape
        self.dataStart = self.batchStart
        vox = np.stack([self._make(i) for i in sel])
        az = self._azimuths[sel]
        images = np.stack(
            [self._render_cached(int(i), v, a, tuple(imageSize))
             for i, v, a in zip(sel, vox, az)]
        )
        euler = np.stack([az, np.zeros_like(az), np.zeros_like(az)], axis=-1)
        cls = np.eye(self._num_classes, dtype=np.float32)[self._labels[sel]]
        inst = np.eye(self._num_inst, dtype=np.float32)[self._insts[sel]]
        return inst, cls, np.sin(euler), np.cos(euler), images, vox[..., None]


class SyntheticMultiObjectLoader(SyntheticVoxelLoader):
    """Synthetic full-scene loader with the Pascal3DMultiObjectLoader batch
    contract: ``getNextBatch(B) -> (images, grid_targets, voxel_lists)``
    (pascal3D.py:547-549 semantics). Each image contains 1..max_objects
    procedural shapes pasted at random scales/positions; grid targets come
    from the same ``build_grid_targets`` the real loader uses — so the
    detector trains end-to-end without a dataset."""

    def __init__(
        self,
        num_samples: int = 512,
        dim: int = 32,
        num_classes: int = 8,
        num_inst: int = 10,
        image_size=(128, 96),
        grid_size=(4, 3),
        predictors_per_cell: int = 5,
        max_objects: int = 3,
        seed: int = 0,
    ):
        super().__init__(num_samples, dim, num_classes, num_inst, seed)
        self.dataStart = 0
        self._image_size = image_size
        self._grid_size = grid_size
        self._p = predictors_per_cell
        self._max_obj = max_objects

    def getNextBatch(self, batchSize: int = 8):
        from anytime3d_tpu.data.pascal3d import build_grid_targets

        render = SyntheticImageObjectLoader._render
        out_c, out_r = self._image_size
        images, targets_list, voxel_lists = [], [], []
        for _ in range(batchSize):
            if self.batchStart >= self.dataLength:
                self.epoch += 1
                self._rng.shuffle(self._idx)
                self.batchStart = 0
            img = np.zeros((out_r, out_c, 3), np.float32)
            n_obj = int(self._rng.integers(1, self._max_obj + 1))
            objs, voxels = [], []
            for _k in range(n_obj):
                i = self._idx[self.batchStart % self.dataLength]
                self.batchStart += 1
                vox = self._make(i)
                az = float(self._rng.uniform(-np.pi, np.pi))
                h = int(self._rng.integers(out_r // 4, out_r // 2 + 1))
                w = int(self._rng.integers(out_c // 4, out_c // 2 + 1))
                r0 = int(self._rng.integers(0, out_r - h + 1))
                c0 = int(self._rng.integers(0, out_c - w + 1))
                patch = render(self, vox, az, (w, h))
                region = img[r0 : r0 + h, c0 : c0 + w]
                np.maximum(region, patch, out=region)
                # metric (w, h, l) from the voxel occupancy extents at a
                # nominal 4 m object scale — trains the bbox3d head so the
                # metric-lifting pipeline (geometry/lifting.py) gets real
                # sizes (KITTI labels provide these on real data)
                occ = np.nonzero(vox > 0.5)
                ext = np.array(
                    [o.max() - o.min() + 1 if len(o) else 1 for o in occ],
                    np.float32,
                ) / vox.shape[0]
                whl = np.array([ext[2], ext[1], ext[0]], np.float32) * 4.0
                objs.append(
                    {
                        "bbox": np.array(
                            [c0 / out_c, r0 / out_r, (c0 + w) / out_c, (r0 + h) / out_r],
                            np.float32,
                        ),
                        "euler_rad": (az, 0.0, 0.0),
                        "inst_onehot": np.eye(self._num_inst, dtype=np.float32)[
                            self._insts[i]
                        ],
                        "voxel_index": len(voxels),
                        "bbox3d_whl": whl,
                    }
                )
                voxels.append(vox[..., None])
            images.append(img)
            targets_list.append(build_grid_targets(objs, self._grid_size, self._p))
            voxel_lists.append(np.stack(voxels))
        self.dataStart = self.batchStart
        targets = {k: np.stack([t[k] for t in targets_list]) for k in targets_list[0]}
        return np.stack(images), targets, voxel_lists
