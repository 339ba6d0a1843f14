"""Per-iteration time of a chained step (the JAX package's
utils/timing.py::chained_ms_per_iter, in PyTorch).

The JAX function runs the step N times inside one jit with a data
dependency between iterations and differences two chain lengths, so the
constant overhead of a call (there: a tunnel's round trip; here: a
launch queue's fill and the final synchronization) cancels. Here the
chain is a Python loop: eager PyTorch has no jit to collapse it, and a
step that consumes its input cannot start before the previous one ends.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List

import torch


def _leaves(state: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple state, in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for k in state for t in _leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [t for v in state for t in _leaves(v)]
    return []


def chained_ms_per_iter(step_fn: Callable, init_state, n_short: int = 2,
                        n_long: int = 6, donate: bool = False) -> float:
    """Time `state = step_fn(i, state)` per iteration, in milliseconds:
    the best of 2 timed chains of `n_short` and of `n_long` calls (each
    after an untimed chain of the same length), their difference over
    `n_long - n_short`. On a state holding CUDA tensors the chains are
    timed by CUDA events on the current stream, else by the host clock.

    step_fn must return a state of the same structure and consume its
    input. `donate=True` runs each chain from the previous chain's output
    instead of `init_state`, so `init_state` need not stay alive for the
    reruns (a step whose state fills most of the card's memory); the state
    then drifts by a few extra steps between timings, which changes no
    shapes."""
    cuda = any(t.is_cuda for t in _leaves(init_state))

    def chain(n, state):
        for i in range(n):
            state = step_fn(i, state)
        return state

    def timed(n, state):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = chain(n, state)
            end.record()
            end.synchronize()
            return start.elapsed_time(end), out
        t0 = time.perf_counter()
        out = chain(n, state)
        return (time.perf_counter() - t0) * 1e3, out

    def run(n, state):
        _, out = timed(n, state)     # warmup
        best = float('inf')
        for _rep in range(2):
            ms, out = timed(n, out if donate else init_state)
            best = min(best, ms)
        return best, out

    t_short, state = run(n_short, init_state)
    t_long, _ = run(n_long, state)
    return max((t_long - t_short) / (n_long - n_short), 1e-6)
