"""Annotation h5 IO and the KPD training-batch loader, a copy of
`betapose_tpu/data/annot.py` (it uses no framework).

Schema parity with the annotator output / KPD trainer input
(`annotate_keypoint.py:403-434`, `train_KPD/src/utils/dataset/coco.py:40-55`):
datasets 'imgname' (char-code arrays), 'bndbox' (N,1,4), 'part' (N,K,2).
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np


def decode_imgname(codes) -> str:
    """Char-code array -> filename (coco.py:70-71)."""
    return "".join(chr(int(c)) for c in np.asarray(codes).reshape(-1)
                   if int(c) != 0)


def encode_imgname(name: str, width: int | None = None) -> np.ndarray:
    codes = [ord(c) for c in name]
    if width is not None:
        codes = codes + [0] * (width - len(codes))
    return np.asarray(codes, dtype=np.int64)


def write_annot_h5(path, imgnames, bndboxes, parts):
    """Write annot_{train,eval}.h5 with the reference's datasets."""
    import h5py
    width = max(len(n) for n in imgnames)
    name_arr = np.stack([encode_imgname(n, width) for n in imgnames])
    with h5py.File(path, "w") as f:
        f.create_dataset("imgname", data=name_arr)
        f.create_dataset("bndbox", data=np.asarray(bndboxes, np.float64))
        f.create_dataset("part", data=np.asarray(parts, np.float64))


def read_annot_h5(path):
    """Returns (imgnames list[str], bndbox (N,4), part (N,K,2))."""
    import h5py
    with h5py.File(path, "r") as f:
        imgname = f["imgname"][:]
        bndbox = f["bndbox"][:]
        part = f["part"][:]
    names = [decode_imgname(row) for row in imgname]
    bndbox = np.asarray(bndbox, np.float32).reshape(len(names), -1)[:, :4]
    return names, bndbox, np.asarray(part, np.float32)


class KPDTrainDataset:
    """Host-side dataset: h5 annotations + image folder, batched with
    background decode; augmentation happens on the device
    (`train/augment.py`)."""

    def __init__(self, h5_path, img_folder, batch_size: int,
                 shuffle: bool = True, seed: int = 0, workers: int = 8,
                 drop_last: bool = True):
        self.names, self.bndbox, self.part = read_annot_h5(h5_path)
        self.img_folder = img_folder
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.workers = workers
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.names)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _load_img(self, idx):
        from betapose_tpu_torch.data.loader import imread_rgb
        path = os.path.join(self.img_folder, self.names[idx])
        return imread_rgb(path).astype(np.float32) / 255.0

    def epoch(self):
        """Yield dict batches of host arrays: imgs [B,H,W,3] f32 RGB[0,1],
        bndbox [B,4], part [B,K,2]."""
        order = np.arange(len(self.names))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        with cf.ThreadPoolExecutor(self.workers) as pool:
            def load_batch(bi):
                idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
                imgs = list(pool.map(self._load_img, idxs))
                return {
                    "imgs": np.stack(imgs),
                    "bndbox": self.bndbox[idxs],
                    "part": self.part[idxs],
                }
            pending = load_batch(0) if nb else None
            for bi in range(nb):
                nxt = pool.submit(load_batch, bi + 1) if bi + 1 < nb else None
                yield pending
                pending = nxt.result() if nxt is not None else None
