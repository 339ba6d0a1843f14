"""Data parallelism over torch.distributed (the JAX package's `parallel/`).

`dist` holds the process group, the batch's split over ranks and the
collectives; `gather` the host objects' gather; `launch` the CLIs'
`--launcher`.
"""
from .dist import (DistContext, all_reduce_mean, all_reduce_sum,
                   average_gradients, barrier, broadcast_state, context,
                   env_context, global_shape, local_rows, synced_normaliser,
                   world_size)
from .gather import (allgather_objects, broadcast_object, evaluate_gathered,
                     pack_objects, unpack_objects)

__all__ = ['DistContext', 'all_reduce_mean', 'all_reduce_sum',
           'average_gradients', 'barrier', 'broadcast_state', 'context',
           'env_context', 'global_shape', 'local_rows', 'synced_normaliser',
           'world_size', 'allgather_objects', 'broadcast_object',
           'evaluate_gathered', 'pack_objects', 'unpack_objects']
