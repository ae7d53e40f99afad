"""Training batches: a numpy batch iterator and the augmentation on the card.

Counterpart of ``heatnet_tpu/data/loaders.py:494-591``. ``batch_iterator`` is
a copy (numpy and a prefetch thread). ``DeviceAugment`` moves a raw batch to
the device and runs ``ops.preprocess.train_sample_preprocess`` over it,
batched, with every sample's random parameters drawn from the caller's
``torch.Generator`` (the JAX version vmaps the chain over per-sample keys).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve
from ..ops.preprocess import TRAIN_WINDOW, draw_train_params, train_sample_preprocess


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Stacked-numpy batch iterator with a background prefetch thread.

    The order is a ``RandomState(seed)`` shuffle; each batch stacks the
    items' arrays key by key.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)

    n_full = len(order) // batch_size
    tail = len(order) % batch_size
    n_batches = n_full + (0 if drop_last or tail == 0 else 1)

    stop = threading.Event()

    def produce(q: queue.Queue):
        try:
            for b in range(n_batches):
                idx = order[b * batch_size:(b + 1) * batch_size]
                items = [dataset[int(i)] for i in idx]
                batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
                # a bounded put that notices a consumer that stopped early,
                # so the thread does not wait on a full queue forever
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        finally:
            while True:
                try:
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    if stop.is_set():
                        break

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    t = threading.Thread(target=produce, args=(q,), daemon=True)
    t.start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                return
            yield batch
    finally:
        stop.set()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:  # crosses as int16 bits, viewed back on arrival
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.uint16)
    return torch.from_numpy(a).to(device)


class DeviceAugment:
    """The train augmentation chain, batched on ``device`` (the card by default).

    ``augment(generator, raw_batch)`` takes a ``batch_iterator`` batch of
    uint8/uint16 frames and returns float32 ``rgb_day``/``ir_day``/
    ``rgb_night``/``ir_night`` (N,h,w,C), int64 ``label_day`` (N,h,w) and
    ``mod_drop_params``, on the device.
    """

    def __init__(self, crop_hw: Tuple[int, int] = (320, 640),
                 device: Optional[Union[str, torch.device]] = None):
        self.crop_hw = tuple(crop_hw)
        self.device = resolve(device)

    def __call__(self, generator: torch.Generator,
                 raw_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        n, h, w = raw_batch["rgb_day"].shape[:3]
        lo, hi = TRAIN_WINDOW
        params = draw_train_params(generator, n, (h, len(range(w)[lo:hi])),
                                   self.crop_hw)
        t = {k: _to_device(raw_batch[k], self.device)
             for k in ("rgb_day", "ir_day", "label_day", "rgb_night", "ir_night")}
        out = train_sample_preprocess(params, t["rgb_day"], t["ir_day"],
                                      t["label_day"], t["rgb_night"],
                                      t["ir_night"], crop_hw=self.crop_hw)
        out["label_day"] = out["label_day"].long()
        return out
