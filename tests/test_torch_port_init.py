"""The port's fresh weights (`models/init.py::flax_init_`) against the JAX
package's `model.init`, for the tiny grounder of tests/test_torch_port_
detector.py and the tiny detector of tests/test_torch_port_detection.py.

The draws cannot be bit-equal (two generators), so each parameter and
running statistic, paired by name through `state_dict_from_jax`, is held
so:

- where the JAX package's initial value is a constant (ones, zeros, the
  prior bias -log(0.99 / 0.01), the grounding head's regression bias of
  0 and -2), the port's equals it bit for bit;
- otherwise by its law's moments, per leaf (its own fan-in or fan-out):
  the standard deviations of the two draws within STD_SIGMAS / sqrt(n)
  of each other (relative), both means within MEAN_SIGMAS standard
  errors of 0, and for n >= TRUNC_MIN_N the truncation at two standard
  deviations of flax's truncated normals (variance scaling, lecun
  normal, the proxy biases) present in the port's draw exactly where it
  is present in the JAX one (max |x| / std under TRUNC_RATIO).

Also: the Runner's fresh weights are `flax_init_`'s with the config's
seed, and a parameter no rule covers raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from proxytransformation_tpu.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as JGrounder)
from proxytransformation_tpu.models.embodied_det3d import (
    Embodied3DDetector as JDetector)
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.engine.runner import (Runner,
                                                     build_model_from_cfg)
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as TGrounder)
from proxytransformation_torch.models.embodied_det3d import (
    Embodied3DDetector as TDetector)
from proxytransformation_torch.models.fcaf3d_head import PRIOR_BIAS
from proxytransformation_torch.models.init import flax_init_
from proxytransformation_torch.utils.config import Config

from test_detector import tiny_batch
from test_torch_port_detection import TINY_DET, det_batch
from test_torch_port_detector import TINY

STD_SIGMAS = 6.0
MEAN_SIGMAS = 6.0
TRUNC_MIN_N = 1000
# a normal truncated at 2 std reaches |x| / std <= 2 / 0.8796 = 2.27 (a
# little more with a sample std); 1000 normal draws pass 2.5 but with a
# probability of 4e-6
TRUNC_RATIO = 2.5
DET_SMOKE = 'configs/detection/synthetic_smoke.py'


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_init(model, batch, mode):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda k, b: model.init(k, b, mode=mode))(
        jax.random.PRNGKey(0), jb)
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)).items()}


MODELS = {
    'grounder': (lambda: JGrounder(**TINY), lambda: tiny_batch(
        np.random.RandomState(0)), 'predict',
        lambda: TGrounder(**TINY, device='cpu')),
    'detector': (lambda: JDetector(**TINY_DET), det_batch, 'loss',
                 lambda: TDetector(**TINY_DET, device='cpu')),
}


@pytest.fixture(scope='module', params=sorted(MODELS))
def both(request):
    jmodel, batch, mode, tmodel = MODELS[request.param]
    want = _jax_init(jmodel(), batch(), mode)
    got = flax_init_(tmodel(), torch.Generator().manual_seed(0))
    return request.param, want, {k: v.numpy()
                                 for k, v in got.state_dict().items()}


def test_constants_equal_the_jax_ones(both):
    name, want, got = both
    assert set(got) == set(want)
    constant = [k for k, w in want.items() if np.all(w == w.flat[0])]
    for k in constant:
        np.testing.assert_array_equal(got[k], want[k], k)
    values = {float(want[k].flat[0]) for k in constant}
    assert {0.0, 1.0, float(np.float32(PRIOR_BIAS))} <= values
    cls = ('neck_3d.conv_cls.bias' if name == 'grounder'
           else 'bbox_head.conv_cls.bias')
    np.testing.assert_array_equal(got[cls], np.float32(-4.59511985))
    if name == 'grounder':
        # the last regression layer: a zero kernel, a bias of 0 and -2
        reg = 'bbox_head.reg_branches.0.4.'
        for leaf in ('weight', 'bias'):
            np.testing.assert_array_equal(got[reg + leaf], want[reg + leaf])
        np.testing.assert_array_equal(got[reg + 'bias'][1:3], [0, -2])


def test_random_laws_match_the_jax_ones_by_their_moments(both):
    _, want, got = both
    drawn = [k for k, w in want.items() if not np.all(w == w.flat[0])]
    assert len(drawn) > 40
    truncated = 0
    for k in drawn:
        w = want[k].astype(np.float64).ravel()
        g = got[k].astype(np.float64).ravel()
        n = w.size
        sw, sg = w.std(), g.std()
        assert abs(sg / sw - 1) <= STD_SIGMAS / np.sqrt(n), (k, sg, sw)
        for x, s in ((w, sw), (g, sg)):
            assert abs(x.mean()) <= MEAN_SIGMAS * s / np.sqrt(n), k
        if n >= TRUNC_MIN_N:
            cut = np.abs(w).max() / sw <= TRUNC_RATIO
            assert (np.abs(g).max() / sg <= TRUNC_RATIO) == cut, k
            truncated += cut
    assert truncated > 10


def test_runner_fresh_weights_are_flax_init(tmp_path):
    cfg = Config.fromfile(DET_SMOKE)
    runner = Runner(cfg, str(tmp_path), device='cpu')
    runner._init_state()
    model = build_model_from_cfg(cfg['model'], 'cpu')
    flax_init_(model, torch.Generator().manual_seed(cfg.get('seed', 0)))
    want = model.state_dict()
    for k, v in runner.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    head = runner.model.bbox_head
    assert torch.equal(head.conv_cls.bias,
                       torch.full_like(head.conv_cls.bias, PRIOR_BIAS))


def test_a_parameter_without_a_rule_raises():
    model = nn.Module()
    model.odd = nn.Module()
    model.odd.w = nn.Parameter(torch.zeros(3))
    with pytest.raises(TypeError, match='odd.w'):
        flax_init_(model, torch.Generator().manual_seed(0))
