"""Batching and device prefetch (counterpart of ``loongx_tpu/data/loader.py``).

A thread pool decodes and synthesises samples on the host, and a one-deep
queue runs the next batch's preparation (host-to-device copy, the frozen
encoders) while the current step runs, so a stalled input pipeline does
not idle the card.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numpy leaves; keep strings as lists; drop None-valued keys."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if vals[0] is None:
            continue
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


def iterate_batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 42,
    num_workers: int = 4,
    epochs: Optional[int] = None,
    drop_last: bool = True,
    host_id: int = 0,
    num_hosts: int = 1,
    skip_batches: int = 0,
    data_index: int = 0,
    data_size: int = 1,
) -> Iterator[Dict[str, Any]]:
    """Yield collated host batches; samples are fetched by a thread pool.

    Several processes: pass (rank, world size) as (host_id, num_hosts) --
    every one draws the same shuffled order (same seed) and takes its
    interleaved slice, so the batches partition the dataset without
    coordination.

    ``skip_batches`` fast-forwards past already-consumed batches (resume):
    the permutation stream advances identically but no samples are fetched.

    Data-parallel ranks (one process each, `parallel.mesh`): pass the
    global batch as ``batch_size`` and the rank's (data index, data extent)
    as (data_index, data_size): every rank walks the same batches and
    fetches only its rows [data_index * b, (data_index + 1) * b), b =
    batch_size / data_size -- the rows `parallel.mesh.shard_batch` gives
    it; the ranks of one data index fetch the same rows.
    """
    if data_size < 1 or batch_size % data_size or not (
            0 <= data_index < data_size):
        raise ValueError(f"a global batch of {batch_size} rows does not split "
                         f"over data rank {data_index} of {data_size}")
    local = batch_size // data_size
    n = len(dataset)
    per_host = len(range(host_id, n, num_hosts))
    if drop_last and per_host < batch_size:
        # every epoch's only batch would be dropped — the iterator would
        # spin forever yielding nothing and the consumer would hang
        raise ValueError(
            f"dataset slice for host {host_id}/{num_hosts} has {per_host} "
            f"samples < batch_size={batch_size} with drop_last=True: no "
            "batch can ever be formed"
        )
    rng = np.random.default_rng(seed)  # same stream on every host
    epoch = 0
    skipped = 0
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        while epochs is None or epoch < epochs:
            order = rng.permutation(n) if shuffle else np.arange(n)
            order = order[host_id::num_hosts]
            for start in range(0, len(order), batch_size):
                idx = order[start : start + batch_size]
                if len(idx) < batch_size and drop_last:
                    continue
                if skipped < skip_batches:
                    skipped += 1
                    continue
                idx = idx[data_index * local:(data_index + 1) * local]
                samples = list(pool.map(dataset.__getitem__, idx.tolist()))
                yield _collate(samples)
            epoch += 1


def background_iter(gen: Iterator, depth: int = 1) -> Iterator:
    """Run any iterator in a background thread with a bounded queue —
    overlaps its work (host decode, device_put, jitted prepare) with the
    consumer.  Producer exceptions re-raise in the consumer.

    When the consumer stops early (train loop break at max_steps, generator
    close), the producer is signalled to stop instead of preparing further
    batches and blocking on the full queue forever — which would pin a
    prepared device batch (and one thread) per train() call for the process
    lifetime."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _DONE = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in gen:
                if not _put(item):
                    return
        except BaseException as exc:  # re-raised in the consumer
            _put(exc)
        finally:
            if hasattr(gen, "close"):
                gen.close()  # its own threads end here, not at exit
            try:
                q.put_nowait(_DONE)
            except queue.Full:
                pass

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so a producer blocked mid-put wakes and exits
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join()  # a thread left running aborts the process at exit


def prefetch_to_device(
    batches: Iterator[Dict[str, Any]],
    size: int = 2,
    device="cuda",
) -> Iterator[Dict[str, Any]]:
    """Copy numpy leaves to ``device`` ahead of consumption (double
    buffering): each array goes through pinned host memory with a
    non-blocking copy when ``device`` is a GPU.  Other leaves (strings)
    pass through on the host."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def to_dev(x):
        if not isinstance(x, np.ndarray):
            return x
        t = torch.from_numpy(np.ascontiguousarray(x))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    return background_iter(
        ({k: to_dev(v) for k, v in b.items()} for b in batches), depth=size)
