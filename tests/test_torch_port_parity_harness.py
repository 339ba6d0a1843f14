"""The JAX package's `check_parity` run on the port.

The port records the npz contract of `converter/parity.py` with its own
forward hooks (`proxytransformation_torch/converter/parity.py::
record_activations`), saves its state_dict as a `.pth`, and the JAX
package's `check_parity` converts that checkpoint and replays every
recorded module. Two models:

(a) the tiny CLIP grounder of the port's tests, flax's fresh weights
    (`flax_init_`), every module of the contract recorded, the
    `detector_builder` the JAX twin of the same config (its `apply`
    jitted). The harness replays the text tower with width / 64 heads
    and the decoder with 8, and reads a basic MinkResNet of other block
    counts than (3, 4, 6, 3) as depth 18, so the config has 1 and 8
    heads and depth 18;
(b) a standalone MinkResNet-101 with the batch-norm stem, in
    tests/test_torch_port_parity_mink101.py (the harness replays its 33
    bottleneck blocks op by op: ~45 s on its own).

Every module must report OK and none SKIP, at the harness's tolerances:
atol 2e-3, and 1e-4 for text_feat_map, bbox_head.reg_branch and the
detector (as tests/test_torch_convert.py holds them).
"""
import jax
import numpy as np
import pytest
import torch

from proxytransformation_tpu.converter.parity import check_parity
from proxytransformation_tpu.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as JGrounder)
from proxytransformation_torch.converter.parity import record_activations
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as TGrounder, batch_to_device)
from proxytransformation_torch.models.init import flax_init_

from test_detector import tiny_batch
from test_torch_port_detector import PREDICT_KEYS, TINY
from test_torch_port_runtime_engine import two_threads  # noqa: F401

# capacities that drop no voxel: the harness rebuilds every level whole
CFG = dict(TINY, text_heads=1, num_heads=8, backbone3d_depth=18,
           sparse_capacities=(1024, 1024, 1024, 512, 256, 128))
TIGHT = {'text_feat_map': 1e-4, 'bbox_head.reg_branch': 1e-4,
         'detector': 1e-4}


@pytest.fixture(autouse=True)
def _threads(two_threads):  # noqa: F811
    yield


class _JittedTwin:
    """The JAX grounder of `CFG` whose `apply` is jitted, as the grounder
    runs (the harness calls `apply(variables, batch, mode='predict')`)."""

    def __init__(self):
        model = JGrounder(**CFG)
        self._fn = jax.jit(lambda v, b: model.apply(v, b, mode='predict'))

    def apply(self, variables, batch, mode):
        assert mode == 'predict'
        return self._fn(variables, batch)


def _grounder():
    model = TGrounder(**CFG, device='cpu')
    flax_init_(model, torch.Generator().manual_seed(0))
    _random_stats(model, 1)
    return model


def _random_stats(model, seed):
    """Running statistics away from flax's fresh 0 / 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith('running_mean'):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith('running_var'):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))


def _save(sd, path):
    torch.save({'state_dict': {k: v.clone() for k, v in sd.items()}},
               str(path))


def _check(results, expect):
    by_name = {name: (err, ok) for name, err, ok in results}
    assert set(by_name) == set(expect), sorted(set(by_name) ^ set(expect))
    for name, (err, ok) in by_name.items():
        assert ok, (name, err)
        assert err <= TIGHT.get(name, 2e-3), (name, err)


def test_check_parity_on_the_tiny_grounder(tmp_path):
    model = _grounder()
    batch = {k: np.asarray(v) for k, v in
             tiny_batch(np.random.RandomState(1), B=1).items()
             if k in PREDICT_KEYS}
    acts = record_activations(model, batch_to_device(batch, 'cpu'))
    assert acts['detector.out_bboxes'].shape[-1] == 9
    _save(model.state_dict(), tmp_path / 'port.pth')
    np.savez(str(tmp_path / 'acts.npz'), **acts)
    log = []
    results = check_parity(str(tmp_path / 'port.pth'),
                           str(tmp_path / 'acts.npz'), atol=2e-3,
                           report=log.append, detector_builder=_JittedTwin)
    assert not [line for line in log if line.startswith(('SKIP', 'FAIL'))]
    _check(results, {
        'text_feat_map', 'text_encoder', 'bbox_head.reg_branch',
        'preshape.simple_encoder', 'preshape.get_offsets',
        *(f'backbone.out{i}' for i in range(4)), 'backbone_3d.stem',
        *(f'backbone_3d.out{i}' for i in range(4)), 'decoder', 'detector'})
