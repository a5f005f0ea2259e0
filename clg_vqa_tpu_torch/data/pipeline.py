"""Host input pipeline: shuffled, microbatched, background-prefetched batches
(port of clg_vqa_tpu/data/pipeline.py:26-130).

The epoch order is a global shuffle seeded by ``seed + epoch``; each host
takes a strided slice of it, padded by wrap-around to an equal length
(DistributedSampler semantics); ``start_step`` skips the batches an
interrupted run already consumed. A background thread assembles up to
``prefetch`` batches ahead and, with ``device_put``, copies each from pinned
host memory to the device with ``non_blocking=True`` (the JAX package's
``jax.device_put``), so the copy overlaps the device's work.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from .. import resolve_device


class TrainPipeline:
    def __init__(self, dataset, *, micro_batch_size: int, grad_acc_steps: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 prefetch: int = 2, drop_remainder: bool = True,
                 device_put: bool = True, device=None,
                 with_features: bool = True):
        """``device_put`` False yields numpy batches; True yields tensors on
        ``device`` (``cuda`` unless the caller passes another)."""
        self.ds = dataset
        self.mbs = micro_batch_size
        self.acc = grad_acc_steps
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder
        self.device = resolve_device(device) if device_put else None
        self.with_features = with_features

    def steps_per_epoch(self) -> int:
        per_host = (len(self.ds) if self.num_hosts == 1
                    else -(-len(self.ds) // self.num_hosts))
        return per_host // (self.mbs * self.acc)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.ds))
        np.random.RandomState(self.seed + epoch).shuffle(order)
        if self.num_hosts == 1:
            return order
        # every host must run the same number of steps, or one would wait
        # in a collective the others never enter
        per_host = -(-len(order) // self.num_hosts)
        padded = np.concatenate(
            [order, order[:per_host * self.num_hosts - len(order)]])
        return padded[self.host_id::self.num_hosts]

    def _assemble(self, idx_chunk: np.ndarray) -> dict:
        b = self.ds.make_batch(idx_chunk.tolist(),
                               with_features=self.with_features)
        for k in ("question_id", "valid", "has_label"):
            b.pop(k, None)
        return {k: np.asarray(v).reshape(self.acc, self.mbs, *np.shape(v)[1:])
                for k, v in b.items()}

    def _to_device(self, host_b: dict) -> dict:
        out = {}
        for k, v in host_b.items():
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[dict]:
        """Yields [acc, mbs, ...] batches of the epoch's (seed + epoch
        keyed) order from step ``start_step`` on."""
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(epoch)
        order = self._epoch_order(epoch)
        span = self.mbs * self.acc
        n_steps = len(order) // span if self.drop_remainder else \
            -(-len(order) // span)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # the sentinel carries an assembly failure to the consumer, so
            # an error never truncates the epoch silently
            err = None
            try:
                for s in range(start_step, n_steps):
                    if stop.is_set():
                        return
                    chunk = order[s * span:(s + 1) * span]
                    if len(chunk) < span:
                        return
                    host_b = self._assemble(chunk)
                    q.put(host_b if self.device is None
                          else self._to_device(host_b))
            except BaseException as e:          # noqa: BLE001 — re-raised
                err = e
            finally:
                q.put(err)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise RuntimeError(
                        "train pipeline batch assembly failed") from item
                yield item
        finally:
            stop.set()
            while t.is_alive():         # drain so the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)
