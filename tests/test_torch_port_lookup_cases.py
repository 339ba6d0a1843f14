"""Inputs of the windowed-lookup tests, shared by the CPU tests
(`test_torch_port_launch.py`, `test_torch_port_ops.py`) and the card
tests (`test_torch_port_cuda.py`). No tests of its own; it imports
numpy and the port's `ops.sparse` only, so it loads on a card host
without JAX as well as here.
"""
import numpy as np

from proxytransformation_torch.ops import sparse as sp


def neck_parents(rng, B, extent, n_fine, V_fine, V_coarse):
    """(keys, queries) as the neck asks them (`MinkNeck`,
    `generative_transpose_map`): each query is the parent key
    linearize(coords // 2) of a fine voxel, in the fine level's key order
    (not ascending: the parent key drops each time y or x steps on), and
    SENTINEL at a masked or empty voxel; the keys are the parents the
    coarse level kept (a random 70%: pruned parents miss), sorted and
    SENTINEL-padded."""
    ex, ey, ez = extent
    cy, cz = ey // 2, ez // 2
    keys = np.full((B, V_coarse), sp.SENTINEL, np.int64)
    q = np.full((B, V_fine), sp.SENTINEL, np.int64)
    for b in range(B):
        fine = np.sort(rng.choice(ex * ey * ez, n_fine, replace=False))
        x, y, z = fine // (ey * ez), fine // ez % ey, fine % ez
        parents = ((x // 2) * cy + y // 2) * cz + z // 2
        q[b, :n_fine] = np.where(rng.rand(n_fine) < 0.9, parents, sp.SENTINEL)
        found = np.unique(parents)
        kept = rng.choice(found, min(V_coarse, int(0.7 * found.size)),
                          replace=False)
        keys[b, :kept.size] = np.sort(kept)
    return keys, q


def lookup_case(case):
    """(keys, queries) of one windowed-lookup case, as numpy int32."""
    rng = np.random.RandomState(len(case))
    top = sp.SENTINEL - 1
    B, V = 2, 20000
    keys = np.full((B, V), sp.SENTINEL, np.int64)
    for b in range(B):
        keys[b, :15000] = np.sort(rng.choice(60000, 15000, replace=False))
    # column-like runs: each sample's keys shifted, in ascending order
    q = np.concatenate([keys[:, :15000] + d for d in (-7, 0, 3)], axis=1)
    if case == 'random_order':
        q = rng.permutation(q.T).T
    elif case == 'sentinel_tile':
        q[:, sp.LOOKUP_TILE:2 * sp.LOOKUP_TILE] = sp.SENTINEL
    elif case == 'oversized':
        q[:, :sp.LOOKUP_TILE // 2] = keys[:, :sp.LOOKUP_TILE // 2]
        q[:, sp.LOOKUP_TILE // 2:sp.LOOKUP_TILE] = \
            keys[:, 15000 - sp.LOOKUP_TILE // 2:15000] - 1
    elif case == 'v1':
        keys = np.array([[5], [sp.SENTINEL]], np.int64)
        q = rng.randint(2, 9, (B, 3000))
        q[:, ::5] = sp.SENTINEL
    elif case == 'below':
        q = rng.randint(-2**31, -1, (B, 5000))
        q[:, :3] = [-2**31, -2**31 + 1, -2]
    elif case == 'near_max':
        keys = np.full((B, 40), sp.SENTINEL, np.int64)
        keys[0, :3] = [top - 3, top - 2, top]
        keys[1, :2] = [top - 1, top]
        q = rng.randint(top - 8, top + 1, (B, 2500))
        q[:, 1::7] = sp.SENTINEL
    elif case == 'neck_parents':  # a coarse row that fits whole
        keys, q = neck_parents(rng, B, (48, 48, 16), 6000, 8000, 3000)
    elif case == 'neck_fenced':  # the same over a row placed by fences
        keys, q = neck_parents(rng, B, (96, 96, 32), 40000, 45000, 20000)
    return (np.ascontiguousarray(keys, np.int32),
            np.ascontiguousarray(q, np.int32))


LOOKUP_CASES = ['random_order', 'sentinel_tile', 'oversized', 'v1', 'below',
                'near_max', 'neck_parents', 'neck_fenced']
