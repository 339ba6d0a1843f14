"""Optimal one-to-one assignment of queries to gts, on the device.

Counterpart of proxytransformation_tpu/ops/hungarian.py. Grounding
samples hold few gts, so the exact optimum comes from a subset DP over
the gts (up to 14: state = bitmask of assigned gts, one step per query);
above that, the Jonker-Volgenant shortest augmenting path. Both follow
the reference step for step in float32, so the same costs give the same
assignment bit for bit, ties included (`torch.argmin` keeps the first
minimum, as `jnp.argmin` does). scipy's `linear_sum_assignment` is only
the tests' oracle.
"""
from __future__ import annotations

import torch

_INF = 1e9
_JINF = 1e15


def _clean(cost: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(cost.float(), nan=100.0, posinf=100.0,
                            neginf=-100.0)


def hungarian_assign_dp(cost: torch.Tensor,
                        num_gts: torch.Tensor) -> torch.Tensor:
    """Subset DP (reference `_dp_assign_single`, :30), batched over the
    leading axis: (N, Q, G) costs, (N,) valid gt counts → (N, Q) int64 gt
    index per query, -1 where unassigned."""
    N, Q, G = cost.shape
    S = 1 << G
    dev = cost.device
    cost = _clean(cost)
    states = torch.arange(S, device=dev)
    bits = 1 << torch.arange(G, device=dev)
    has = (states[:, None] & bits[None, :]) > 0            # (S, G)
    prev_state = states[:, None] ^ bits[None, :]           # (S, G)
    inf = torch.tensor(_INF, device=dev)
    dp = torch.full((N, S), _INF, device=dev)
    dp[:, 0] = 0.0
    choices = []
    for q in range(Q):
        # candidates: take gt g at this query, arriving from state s ^ g
        prev = dp[:, prev_state]                           # (N, S, G)
        cands = torch.where(has, prev + cost[:, q, None, :], inf)
        best_g = torch.argmin(cands, dim=2)                # first minimum
        best = torch.gather(cands, 2, best_g[..., None])[..., 0]
        take = best < dp
        dp = torch.where(take, best, dp)
        choices.append(torch.where(take, best_g + 1, 0))
    s = (1 << num_gts.long().to(dev)) - 1                  # (N,)
    out = torch.empty((N, Q), dtype=torch.int64, device=dev)
    for q in range(Q - 1, -1, -1):
        g = torch.gather(choices[q], 1, s[:, None])[:, 0]
        assigned = g > 0
        out[:, q] = torch.where(assigned, g - 1, -1)
        s = torch.where(assigned, s ^ (1 << (g - 1).clamp(min=0)), s)
    return out


def _jv_assign_single(cost: torch.Tensor, num_g: int) -> torch.Tensor:
    """Jonker-Volgenant (reference `_jv_assign_single`, :90) for one
    (Q, G) cost; the loops are the reference's while loops, driven from
    the host."""
    Q, G = cost.shape
    dev = cost.device
    cT = _clean(cost.T)                                     # (G rows, Q cols)
    valid_row = torch.arange(G, device=dev) < num_g
    cT = torch.where(valid_row[:, None], cT, torch.zeros_like(cT))
    u = torch.zeros(G, device=dev)
    v = torch.zeros(Q, device=dev)
    p = torch.full((Q, ), -1, dtype=torch.int64, device=dev)
    for i in range(G):
        minv = torch.full((Q, ), _JINF, device=dev)
        way = torch.full((Q, ), -1, dtype=torch.int64, device=dev)
        used = torch.zeros(Q, dtype=torch.bool, device=dev)
        j0 = -1
        while True:
            if j0 >= 0:
                used[j0] = True
            i0 = int(p[j0]) if j0 >= 0 else i
            cur = cT[i0] - u[i0] - v                       # reduced costs
            upd = (~used) & (cur < minv)
            minv = torch.where(upd, cur, minv)
            way = torch.where(upd, torch.full_like(way, j0), way)
            d = torch.where(used, torch.full_like(minv, _JINF), minv)
            j1 = int(torch.argmin(d))
            delta = d[j1]
            # rows on the alternating path: i and the matched rows of
            # settled columns; their u rises, settled v falls
            on_path = torch.zeros(G, dtype=torch.bool, device=dev)
            on_path[i] = True
            on_path[p[used]] = True
            u = u + torch.where(on_path, delta, torch.zeros_like(u))
            v = v - torch.where(used, delta, torch.zeros_like(v))
            minv = torch.where(used, minv, minv - delta)
            j0 = j1
            if int(p[j1]) < 0:                             # free column
                break
        j = j0
        while j >= 0:
            pj = int(way[j])
            p[j] = int(p[pj]) if pj >= 0 else i
            j = pj
    return torch.where((p >= 0) & (p < num_g), p, -1)


def hungarian_assign_jv(cost: torch.Tensor,
                        num_gts: torch.Tensor) -> torch.Tensor:
    """Batched JV for any gt count: (N, Q, G) → (N, Q)."""
    return torch.stack([_jv_assign_single(c, int(n))
                        for c, n in zip(cost, num_gts)])


def hungarian_assign(cost: torch.Tensor,
                     num_gts: torch.Tensor) -> torch.Tensor:
    """One-to-one matching of queries to padded gts (reference
    `hungarian_assign`, :195, method 'auto'): (N, Q, G) costs, (N,) valid
    gt counts → (N, Q) int64 gt index per query, -1 where unassigned;
    the subset DP up to 14 gts, JV above."""
    if cost.shape[-1] > 14:
        return hungarian_assign_jv(cost, num_gts)
    return hungarian_assign_dp(cost, num_gts)
