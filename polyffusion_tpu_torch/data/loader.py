"""Batch iteration with pitch-shift augmentation and background host-to-device
feeding (counterpart of the JAX package's ``data/loader.py``).

Replaces the reference's torch DataLoader + collate_fn (``data/dataloader.py:25-137``):
per-batch random pitch shift in [-6, 6), chord (32,14) -> one-hot (32,36). A
background thread collates the next batches, compresses them to small integer
dtypes, pins them and starts their copies to the card (``non_blocking``) while
the card runs the current step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.reprs import chd_pitch_shift, chd_to_onehot, pianotree_pitch_shift, pr_mat_pitch_shift
from .dataset import SegmentDataset


class Batch(NamedTuple):
    """One training batch (host NumPy arrays or torch tensors)."""

    prmat2c: np.ndarray  # (B, 2, 128, 128) float32
    pnotree: np.ndarray  # (B, 128, 20, 6) int64
    chord: np.ndarray  # (B, 32, 36) float32 one-hot
    prmat: np.ndarray  # (B, 128, 128) float32


def collate(samples, shift: int = 0) -> Batch:
    """Stack segment tuples into a Batch, applying one pitch shift to all of them
    (reference ``collate_fn``, ``data/dataloader.py:25-66``)."""
    prmat2c, pnotree, chord, prmat = [], [], [], []
    for p2c, pt, chd, pr in samples:
        if shift:
            p2c = pr_mat_pitch_shift(p2c, shift)
            pt = pianotree_pitch_shift(pt, shift)
            chd = chd_pitch_shift(chd, shift)
            pr = pr_mat_pitch_shift(pr, shift)
        prmat2c.append(p2c)
        pnotree.append(pt)
        chord.append(chd_to_onehot(chd))
        prmat.append(pr)
    return Batch(
        np.array(prmat2c, np.float32),
        np.array(pnotree, np.int64),
        np.array(chord, np.float32),
        np.array(prmat, np.float32),
    )


def decompress_batch(batch):
    """Inverse of ``DeviceFeeder._compress``, on the device: uint8 -> float32,
    int16 -> int32; tensors already in compute dtypes pass through."""

    def un(v):
        if not isinstance(v, torch.Tensor):
            return v
        if v.dtype == torch.uint8:
            return v.float()
        if v.dtype == torch.int16:
            return v.int()
        return v

    vals = [un(v) for v in batch]
    return Batch(*vals) if isinstance(batch, Batch) else tuple(vals)


class BatchLoader:
    """Shuffling epoch iterator over a SegmentDataset.

    ``augment=True`` draws one pitch shift in [-6, 6) per batch (matching the
    reference's per-batch augmentation).  ``drop_last=True`` keeps batch shapes
    fixed.
    """

    def __init__(
        self,
        dataset: SegmentDataset,
        batch_size: int,
        *,
        augment: bool = False,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.augment = augment
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        n_full = len(self) * self.batch_size if self.drop_last else len(order)
        for start in range(0, n_full, self.batch_size):
            idxs = order[start : start + self.batch_size]
            shift = int(self._rng.choice(np.arange(-6, 6))) if self.augment else 0
            yield collate([self.dataset[int(i)] for i in idxs], shift)


class DeviceFeeder:
    """Background-thread prefetcher that places batches on the device.

    While the card runs step N, the thread collates batch N+1 and starts its
    copy from pinned host memory. The copies go to the current stream of the
    thread (the device's default stream), so the step that reads a batch is
    ordered after its copy.

    ``used_fields``: optional set of Batch field names the consuming task
    actually reads (``task.used_batch_fields``).  Unused fields are replaced
    with (B, 1) zero placeholders before the copy — for a chord-conditioned
    sdf run this cuts the per-step host-to-device traffic about fourfold.
    """

    def __init__(self, loader, device: DeviceLike = None, prefetch: int = 2, used_fields=None):
        self.loader = loader
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.used_fields = set(used_fields) if used_fields is not None else None

    def _strip(self, batch: Batch) -> Batch:
        if self.used_fields is None:
            return batch
        b = batch.prmat2c.shape[0]
        placeholder = np.zeros((b, 1), np.float32)
        return Batch(
            *[
                v if name in self.used_fields else placeholder
                for name, v in zip(Batch._fields, batch)
            ]
        )

    @staticmethod
    def _compress(batch: Batch) -> Batch:
        """Lossless dtype compression before the host-to-device copy.

        Every field is small-integer-valued: prmat2c/chord are 0/1, prmat
        holds grid-step durations (<= 128), pnotree holds pitch/duration
        indices (<= 130).  uint8/int16 on the wire is a 4-8x transfer cut;
        the task casts back to compute dtypes on the device
        (``decompress_batch``)."""

        def pack(name, v):
            if v.dtype == np.float32 and name in ("prmat2c", "chord", "prmat"):
                # only values uint8 can represent: NaN/inf or out-of-range data
                # (e.g. a poisoned batch) must reach the device unmangled so the
                # NaN-loss check can fire
                mn, mx = float(v.min(initial=0)), float(v.max(initial=0))
                if not (np.isfinite(mn) and np.isfinite(mx) and 0 <= mn and mx <= 255):
                    return v
                u = v.astype(np.uint8)
                if not np.array_equal(u, v):  # fractional values: send uncompressed
                    return v
                return u
            if v.dtype == np.int64 and name == "pnotree":
                return v.astype(np.int16)
            return v

        return Batch(*[pack(n, v) for n, v in zip(Batch._fields, batch)])

    def _place(self, batch: Batch) -> Batch:
        tensors = [torch.from_numpy(v) for v in self._compress(self._strip(batch))]
        if self.device.type == "cuda":
            tensors = [t.pin_memory().to(self.device, non_blocking=True) for t in tensors]
        return Batch(*tensors)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()
        err: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(self._place(batch)):
                        return
            except Exception as e:  # surfaced on the consumer side
                err.append(e)
            put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # the consumer may stop early (max_steps): release the thread
            stop.set()
            t.join()


def make_loaders(
    train_ds: SegmentDataset,
    val_ds: SegmentDataset,
    batch_size: int,
    device: DeviceLike = None,
    seed: int = 0,
    prefetch: int = 2,
    used_fields=None,
):
    """``used_fields``: pass the task's ``used_batch_fields`` so untouched
    Batch fields never cross to the device (see DeviceFeeder)."""
    train = DeviceFeeder(
        BatchLoader(train_ds, batch_size, augment=True, shuffle=True, seed=seed),
        device,
        prefetch,
        used_fields,
    )
    val = DeviceFeeder(
        BatchLoader(val_ds, batch_size, augment=False, shuffle=False, seed=seed),
        device,
        prefetch,
        used_fields,
    )
    return train, val
