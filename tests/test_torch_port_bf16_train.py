"""One bfloat16 train step of the whole grounder against the JAX package's.

The tiny grounder with `compute_dtype='bfloat16', remat_painting=True`
takes one AdamW step on both sides from one state dict and batch
(tests/test_torch_port_train.py's `run_jax` / `run_port`), the JAX side
on its TPU conv path with every bfloat16 operation rounded (see
tests/test_torch_port_bf16_model.py). Both preshapes return their input
points (`identity_preshape`), so the step is held from the voxelization
on. The preshape's proxy block and image pooling are held on their own
in train mode, outputs and gradients, with the same dropout masks on
both sides (tests/test_torch_port_bf16_modules.py::
test_preshape_block_and_pool_bf16_train_grads_match).
"""
import numpy as np
import pytest

from proxytransformation_tpu.models import preshape as jpre
from proxytransformation_torch.models import preshape as tpre

from test_detector import tiny_batch
from test_torch_port_bf16_model import (  # noqa: F401 (a fixture)
    BF16_TINY, EXACT, tpu_conv_path, two_torch_threads)
from test_torch_port_detector import tiny_state_dict
from test_torch_port_train import run_jax, run_port


def run_train():
    """One bf16 train step on both sides, and the port's float32 step,
    from the same state; the preshapes return their input points
    (`identity_preshape`)."""
    sd = tiny_state_dict()
    batch = {k: np.asarray(v) for k, v in
             tiny_batch(np.random.RandomState(1), L=8).items()}
    mp = pytest.MonkeyPatch()
    try:
        identity_preshape(mp)
        with tpu_conv_path():
            want, _, jseen = run_jax(sd, batch, 1, mp, cfg=BF16_TINY,
                                     compiler_options=EXACT)
        got, tseen, frozen_same, _ = run_port(sd, batch, {}, 1,
                                              cfg=BF16_TINY)
        f32, _, _, _ = run_port(sd, batch, {}, 1,
                                cfg=dict(BF16_TINY, compute_dtype='float32'))
    finally:
        mp.undo()
    return dict(want=want[0], got=got[0], f32=f32[0], jseen=jseen,
                tseen=tseen, frozen_same=frozen_same)


def identity_preshape(mp):
    """Both preshapes return the points and mask they are given. In
    train mode the preshape's float32 rounding noise (batch statistics
    over few clusters: E[x²] - E[x]² cancels) reaches its bfloat16
    blocks, which turn it into one-ulp differences, and those move points
    by ~3e-3 and across voxel boundaries. The preshape's blocks are held
    on their own in train mode (tests/test_torch_port_bf16_modules.py);
    the step is held from the voxelization on, on identical points."""
    mp.setattr(jpre.ProxyTransformationNormReverse, '__call__',
               lambda self, points, mask, *a, **kw: (points, mask))
    mp.setattr(tpre.ProxyTransformationNormReverse, 'forward',
               lambda self, points, mask, *a, **kw: (points, mask))


@pytest.fixture(scope='module')
def train():
    return run_train()


def test_bf16_train_step_integer_stages(train):
    """The level-0 voxel keys and the Hungarian assignment of both
    decoder layers, bit for bit; frozen parameters unchanged."""
    for a, b in zip(train['jseen']['keys'], train['tseen']['keys']):
        np.testing.assert_array_equal(b, a)
    want = np.stack(train['jseen']['assign'][:2])
    np.testing.assert_array_equal(train['tseen']['assign'][0], want)
    assert (want >= 0).sum() > 0
    assert train['frozen_same']


def test_bf16_train_step_losses_match(train):
    """The four losses and their total within 1e-4 relative (measured
    2e-5 to 5e-5: one-ulp differences carried through the bf16 layers),
    the global gradient norm within 5% (measured 1.8% at two torch
    threads, less at eight: the port's summation order changes with its
    thread count, and the norm squares every gradient, the ReLU flips
    below included)."""
    want, got = train['want']['metrics'], train['got']['metrics']
    assert set(got) == set(want)
    for k, v in want.items():
        rtol = 5e-2 if k == 'grad_norm' else 1e-4
        np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


GRAD_RTOL = 5e-2


def _grad_errors(grads, want, grad_norm):
    """Per tensor: max |g - want| over (max |want| + 1e-6 grad_norm)."""
    return {k: float(np.abs(g - want[k]).max()
                     / (np.abs(want[k]).max() + 1e-6 * grad_norm))
            for k, g in grads.items()}


def test_bf16_train_step_gradients_match(train):
    """At least 99% of the gradient tensors within GRAD_RTOL of their
    largest entry (measured: all but two of 403, median 1.1e-3), every one
    within 0.5 (a pre-activation one bf16 ulp from zero falls on the
    other side of a ReLU: the FFN's hidden units see 32 queries, so one
    flip moves a bias gradient by up to a third of its largest entry);
    and the median error at most a twentieth of the port's float32
    step's against the same JAX bf16 step (measured 7e-2: the test
    tells bf16 from float32)."""
    want = train['want']['grads']
    gn = train['want']['metrics']['grad_norm']
    err = _grad_errors(train['got']['grads'], want, gn)
    err32 = _grad_errors(train['f32']['grads'], want, gn)
    over = {k: e for k, e in err.items() if e > GRAD_RTOL}
    assert len(over) <= 0.01 * len(err), over
    assert max(err.values()) <= 0.5, over
    assert np.median(list(err.values())) <= np.median(
        list(err32.values())) / 20


def parity_report() -> None:
    """Print the bf16 step's metrics on both sides and its gradient
    errors beside the float32 step's."""
    r = run_train()
    gn = r['want']['metrics']['grad_norm']
    for k, v in sorted(r['want']['metrics'].items()):
        print(f'{k}: JAX bf16 {v:.7g}, port bf16 {r["got"]["metrics"][k]:.7g}'
              f', port float32 {r["f32"]["metrics"][k]:.7g}')
    err = _grad_errors(r['got']['grads'], r['want']['grads'], gn)
    err32 = _grad_errors(r['f32']['grads'], r['want']['grads'], gn)
    worst = sorted(err.items(), key=lambda kv: -kv[1])[:3]
    print(f'gradient errors (of each tensor\'s max): bf16 median '
          f'{np.median(list(err.values())):.3g}, over {GRAD_RTOL}: '
          f'{sum(e > GRAD_RTOL for e in err.values())} of {len(err)}, worst '
          f'{worst}; float32 step median {np.median(list(err32.values())):.3g}')


if __name__ == '__main__':
    # PYTHONPATH=.:tests python tests/test_torch_port_bf16_train.py
    import jax
    import torch
    jax.config.update('jax_platforms', 'cpu')
    torch.set_num_threads(2)
    parity_report()

