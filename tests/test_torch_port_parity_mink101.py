"""The JAX package's `check_parity` on the port's MinkResNet-101 with the
batch-norm stem (tests/test_torch_port_parity_harness.py holds the tiny
grounder; this case has a file of its own because the harness replays
its 33 bottleneck blocks op by op, ~45 s).

The port records the stem and every stage (`record_activations`) at tiny
capacities. A backbone-only `.pth` does not convert (`convert_detector`
always converts the preshape), so the checkpoint is the tiny grounder's
with its `backbone_3d.*` entries replaced. Depth 101 and not 50:
`convert_detector` takes the first depth whose block counts match, and
34 and 50 share (3, 4, 6, 3). Every module must report OK within the
harness's atol 2e-3, none SKIP.
"""
import numpy as np
import torch

from proxytransformation_tpu.converter.parity import check_parity
from proxytransformation_torch.converter.parity import record_activations
from proxytransformation_torch.models.init import flax_init_
from proxytransformation_torch.models.norms import BatchNormParams
from proxytransformation_torch.models.sparse_resnet import MinkResNet
from proxytransformation_torch.ops.sparse import voxelize_points

from test_torch_port_parity_harness import _check, _grounder, _save
from test_torch_port_runtime_engine import two_threads  # noqa: F401


def test_check_parity_on_minkresnet101_with_the_bn_stem(tmp_path, monkeypatch,
                                                       two_threads):  # noqa: F811
    """Running statistics set to one train-mode pass's batch statistics,
    so that the eval forward normalizes as training would (fresh 0 / 1
    statistics let 33 residual blocks grow the features to ~1e5, where
    float32 rounding alone passes the harness's absolute 2e-3)."""
    caps = (1024, ) * 6
    mink = MinkResNet(101, 3, caps, norm='batch')
    flax_init_(mink, torch.Generator().manual_seed(2))
    rng = np.random.RandomState(4)
    pts = torch.from_numpy(rng.uniform(0, 1.5, (1, 600, 3)).astype(
        np.float32))
    mask = torch.ones((1, 600), dtype=torch.bool)
    level0 = voxelize_points(pts, mask, pts, 0.01, caps[0], (256, 256, 256))
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(BatchNormParams, '_update', lambda self, mean, var, _: (
            self.running_mean.copy_(mean), self.running_var.copy_(var)))
        mink(level0, train=True)
    acts = record_activations(mink, level0)
    assert set(k.rsplit('.', 1)[0] for k in acts) == {
        'backbone_3d.stem', 'backbone_3d'}
    assert max(np.abs(acts[f'backbone_3d.out{i}_feats']).max()
               for i in range(4)) < 100
    sd = {k: v for k, v in _grounder().state_dict().items()
          if not k.startswith('backbone_3d.')}
    sd.update({f'backbone_3d.{k}': v for k, v in mink.state_dict().items()})
    _save(sd, tmp_path / 'mink101.pth')
    np.savez(str(tmp_path / 'acts.npz'), **acts)
    log = []
    results = check_parity(str(tmp_path / 'mink101.pth'),
                           str(tmp_path / 'acts.npz'), atol=2e-3,
                           report=log.append)
    assert not [line for line in log if line.startswith(('SKIP', 'FAIL'))]
    _check(results, {'backbone_3d.stem',
                     *(f'backbone_3d.out{i}' for i in range(4))})
