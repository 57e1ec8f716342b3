"""Host input pipeline: threaded decode, batching, and copies to the card
ahead of compute.

Counterpart of ``stereoformer_tpu/data/loader.py``. ``DataLoader`` decodes
and augments samples on a thread pool (numpy and PIL release the
interpreter lock in their inner loops), keeps a bounded number of batches
in flight, and raises a worker's error in the consumer. The shuffle order
comes from (seed, epoch) and each sample's augmentation generator from
(seed, epoch, index), so the batches do not depend on which thread ran
what. ``DevicePrefetcher`` takes the place of the JAX package's
``prefetch_to_device``: it copies each batch to the card on a side stream,
a few batches ahead of the step that reads it.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

BATCH_KEYS = ("img_left", "img_right", "gt_disp", "pseudo_disp")


def num_workers_default() -> int:
    """The reference's ``datathread`` environment variable, default 4."""
    return int(os.environ.get("datathread", "4"))


def _collate(samples: list[dict], pin_memory: bool = False) -> dict:
    """Stack the samples' arrays as float32, disparities as [N, H, W, 1].
    With ``pin_memory`` the stacks are written straight into page-locked
    torch tensors, ready for an asynchronous copy to the card; else they
    are numpy arrays."""
    batch = {}
    for k in BATCH_KEYS:
        if k not in samples[0]:
            continue
        arrs = [s[k] for s in samples]
        shape = (len(arrs),) + arrs[0].shape
        if k in ("gt_disp", "pseudo_disp") and len(shape) == 3:
            shape += (1,)   # NHW -> NHW1
        if pin_memory:
            out = torch.empty(shape, dtype=torch.float32, pin_memory=True)
            np.stack(arrs, out=out.numpy().reshape((len(arrs),)
                                                   + arrs[0].shape))
        else:
            out = np.stack(arrs).astype(np.float32).reshape(shape)
        batch[k] = out
    if "left_name" in samples[0]:
        batch["left_name"] = [s["left_name"] for s in samples]
    return batch


class DataLoader:
    """Iterable over batched sample dicts, decoded on ``num_workers``
    threads (none: in the consumer), at most ``prefetch`` + 1 batches of
    samples in flight. ``transform_with_rng(sample, rng)`` runs on each
    sample with its own generator. ``pin_memory`` collates into
    page-locked torch tensors (only where CUDA is present).

    ``shard=(rank, n)``: each batch is this data-parallel rank's rows of
    the global batch of ``batch_size`` (rows ``rank * batch_size / n`` on),
    each decoded and augmented as in one process, the shuffle the same on
    every rank. A short last batch (``drop_last=False``) is padded to
    ``batch_size`` first with samples of zeros, so every rank gets its rows
    (``parallel.pad_batch_to``'s padding)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: Optional[int] = None,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        transform_with_rng=None,
        pin_memory: bool = False,
        shard: tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = (
            num_workers_default() if num_workers is None else num_workers
        )
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.transform_with_rng = transform_with_rng
        self.pin_memory = pin_memory
        self.shard = shard
        if batch_size % shard[1]:
            raise ValueError(f"a batch of {batch_size} does not divide by "
                             f"{shard[1]} ranks")
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + 977 * self.epoch).shuffle(idx)
        return idx

    def _load_one(self, index: int) -> dict:
        if index < 0:
            # a padding row: zeros shaped as sample -index - 1
            sample = self._load_one(-index - 1)
            return {k: (np.zeros_like(v) if isinstance(v, np.ndarray) else v)
                    for k, v in sample.items()}
        sample = self.dataset[int(index)]
        if self.transform_with_rng is not None:
            rng = np.random.default_rng((self.seed, self.epoch, int(index)))
            sample = self.transform_with_rng(sample, rng)
        return sample

    def _rows(self, batch: np.ndarray) -> list:
        """This rank's rows of a global batch, a padding row as -(i + 1)
        for a sample i of the batch."""
        rank, n = self.shard
        rows = list(batch) + [-int(batch[0]) - 1] * (self.batch_size
                                                     - len(batch))
        per = self.batch_size // n
        return rows[rank * per:(rank + 1) * per]

    def __iter__(self) -> Iterator[dict]:
        order = self._index_order()
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.shard[1] > 1:
            batches = [self._rows(b) for b in batches]
        if self.num_workers <= 0:
            for b in batches:
                yield _collate([self._load_one(i) for i in b],
                               self.pin_memory)
            return

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    # only prefetch + 1 batches of samples in flight: the
                    # whole epoch at once would hold every decoded sample
                    in_flight: deque = deque()
                    it = iter(batches)
                    while True:
                        while len(in_flight) <= self.prefetch:
                            b = next(it, None)
                            if b is None:
                                break
                            in_flight.append(
                                [pool.submit(self._load_one, i) for i in b])
                        if not in_flight:
                            break
                        fb = in_flight.popleft()
                        if stop.is_set():
                            for flist in in_flight:
                                for f in flist:
                                    f.cancel()
                            return
                        out_q.put(_collate([f.result() for f in fb],
                                           self.pin_memory))
            except Exception as e:  # raised again in the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, then let it end
            while t.is_alive():
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()


class DevicePrefetcher:
    """Iterate ``batches`` (host dicts of numpy arrays or torch tensors) as
    dicts of tensors on ``device``; other values (file names) pass through.

    On a CUDA device each batch is copied on a side stream, ``DEPTH``
    batches ahead of the consumer (as the JAX trainer's prefetch), with ``non_blocking`` copies (truly
    asynchronous from page-locked tensors, as ``DataLoader(pin_memory=
    True)`` gives them). Before a batch is handed out, the current stream
    waits for that batch's copies (an event recorded after them), and each
    tensor is marked as used on the current stream, so its memory is not
    given to a later copy while the step still reads it. A page-locked
    source may be dropped as soon as its copy is queued: PyTorch's host
    allocator holds it until the copy has finished. On the CPU the arrays
    become tensors sharing their memory, in order."""

    DEPTH = 2

    def __init__(self, batches: Iterable[dict], device):
        self.batches = batches
        self.device = torch.device(device)

    def __iter__(self) -> Iterator[dict]:
        if self.device.type != "cuda":
            for batch in self.batches:
                yield {k: _as_tensor(v) for k, v in batch.items()}
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        buf: deque = deque()
        for batch in self.batches:
            with torch.cuda.stream(side):
                dev = {k: (_as_tensor(v).to(self.device, non_blocking=True)
                           if _is_array(v) else v)
                       for k, v in batch.items()}
                done = torch.cuda.Event()
                done.record(side)
            buf.append((dev, done))
            if len(buf) > self.DEPTH:
                yield self._hand_out(*buf.popleft())
        while buf:
            yield self._hand_out(*buf.popleft())

    def _hand_out(self, dev: dict, done) -> dict:
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(done)
        for v in dev.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(cur)
        return dev


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def _as_tensor(v):
    return torch.from_numpy(v) if isinstance(v, np.ndarray) else v
