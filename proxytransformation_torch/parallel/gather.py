"""Gathering host objects (eval results) from every rank.

The port's own copy of proxytransformation_tpu/parallel/gather.py: the
reference gathers each rank's metric results with mmengine's
`collect_device='cpu'` (reference eval/metrics/grounding_metric.py:43-44).
The JAX package pickles each host's list into a uint8 vector
(`pack_objects`), gathers the lengths and the vectors and unpickles them
in host order (`unpack_objects`); here the same framing travels through
`torch.distributed.all_gather_object` on the gloo group of host objects.

`evaluate_gathered` is what a metric's `evaluate` does under data
parallelism: every rank gathers, rank 0 computes the metric (and writes
any dump), and every rank receives rank 0's result.
"""
from __future__ import annotations

import pickle
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from .dist import context, cpu_group, world_size


def pack_objects(objs: Sequence) -> np.ndarray:
    """Pickle a list of objects into a uint8 vector."""
    return np.frombuffer(pickle.dumps(list(objs)), np.uint8)


def unpack_objects(buf: np.ndarray, length: int) -> List:
    """Inverse of `pack_objects` for a (possibly padded) uint8 vector."""
    return pickle.loads(bytes(np.asarray(buf[:length], np.uint8)))


def allgather_objects(objs: Sequence) -> List:
    """Every rank's objects concatenated in rank order, on every rank;
    `list(objs)` at world size 1."""
    world = world_size()
    if world == 1:
        return list(objs)
    local = pack_objects(objs)
    gathered: List[Any] = [None] * world
    dist.all_gather_object(gathered, (local.size, local), group=cpu_group())
    out: List = []
    for length, buf in gathered:
        out.extend(unpack_objects(buf, length))
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank `src`'s `obj` on every rank (`obj` at world size 1)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=cpu_group())
    return box[0]


def gather_in_order(results: Sequence, order: Optional[Sequence] = None
                    ) -> List:
    """Every rank's `results` in one list: sorted by `order` (each result's
    key, e.g. its position in the loader) when given, else in rank order."""
    if order is None:
        return allgather_objects(results)
    if len(order) != len(results):
        raise ValueError(f'{len(order)} order keys for {len(results)} '
                         'results')
    pairs = allgather_objects(list(zip(order, range(len(order)), results)))
    return [r for _, _, r in sorted(pairs, key=lambda p: p[:2])]


def evaluate_gathered(compute: Callable[[List], Any], results: Sequence,
                      order: Optional[Sequence] = None) -> Any:
    """`compute(every rank's results)` on rank 0, its value on every rank
    (the identity's gather and broadcast at world size 1)."""
    gathered = gather_in_order(results, order)
    value = compute(gathered) if context().is_main else None
    return broadcast_object(value)
