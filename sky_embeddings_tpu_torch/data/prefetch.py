"""Host-to-device prefetch (port of ``sky_embeddings_tpu/data/prefetch.py``).

Keeps a pipeline of ``size`` batches already on their way to the device, so
that a training step never starts with a copy: while step N runs, batch N+1
is in flight. On a CUDA device every numpy array (or CPU tensor) of a batch
is copied into pinned host memory and sent with ``non_blocking=True`` on a
side stream, which records an event; when the batch is yielded, the
consumer's current stream waits on that event and each of its tensors is
marked used on that stream (``record_stream``), so the caching allocator
does not hand the memory back before the step that reads it has run. A copy
from pageable memory would instead wait for the device to drain first. A
tensor already on a CUDA device (what ``data/device_cache.DeviceDataset``
yields) passes through as it is, with no copy. With ``device="cpu"`` the
arrays become tensors (``torch.as_tensor``). A pin or a copy that fails
raises: no path falls back to a synchronous copy.

Batches are dicts (or lists and tuples) of arrays; other leaves (numbers,
strings) pass through. ``sharding`` (``parallel/mesh.Sharding``, JAX's
``NamedSharding`` argument) names the device: with one process a layout
changes nothing else; across processes each item is the rank's local shard
of the global batch on the rank's device, as ``parallel/distributed.put_global``
puts it (under DDP no tensor holds the global batch).
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from sky_embeddings_tpu_torch.utils.device import resolve_device


def map_leaves(fn, item):
    """``fn`` over the array leaves (numpy arrays and tensors) of nested
    dicts, lists and tuples; other leaves as they are."""
    if isinstance(item, dict):
        return {k: map_leaves(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(map_leaves(fn, v) for v in item)
    if isinstance(item, np.ndarray) or torch.is_tensor(item):
        return fn(item)
    return item


def device_prefetch(iterator: Iterable[Any], size: int = 2,
                    device: str | torch.device = "cuda", sharding=None) -> Iterator[Any]:
    """Yield the items of ``iterator`` in order, each already sent to
    ``device`` (``sharding.device`` when a layout is given), the source read
    at most ``size`` items ahead."""
    dev = resolve_device(device if sharding is None else sharding.device)
    it = iter(iterator)
    buf: collections.deque = collections.deque()
    stream: Optional[torch.cuda.Stream] = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item):
        """(the item on the device, its copies' event, the copies)."""
        if stream is None:
            return map_leaves(torch.as_tensor, item), None, []
        copies: list[torch.Tensor] = []

        def to_device(x):
            if torch.is_tensor(x) and x.device.type == "cuda":
                return x
            host = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
            copies.append(host.pin_memory().to(dev, non_blocking=True))
            return copies[-1]

        with torch.cuda.stream(stream):
            out = map_leaves(to_device, item)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event, copies

    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass

    while buf:
        out, event, copies = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        if event is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(event)
            for t in copies:
                t.record_stream(current)
        yield out
