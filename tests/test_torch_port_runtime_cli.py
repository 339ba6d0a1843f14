"""The port's Runner and its train / test / eval CLIs on the CPU, and
its import hygiene.

- The Runner trains `configs/grounding/synthetic_smoke.py` one epoch and
  validates; its first step's losses equal `make_train_step`'s on the
  same collated batch, the same seeded weights and the same generator.
- The CLIs' `main(argv)` train, test and evaluate with `--device cpu`,
  and `python -m` reaches each CLI's `main`; without a card and without
  `--device cpu` the Runner and the CLIs raise.
- Import hygiene: the port and chip_smoke.py import no jax, flax,
  proxytransformation_tpu, regex, cv2, orbax, optax or open_clip, and
  wandb and transformers only inside the optional branches the JAX
  package guards (the text towers import neither transformers nor
  open_clip); loading the CLIs loads none of them.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from proxytransformation_torch.data.synthetic import flagship_batch
from proxytransformation_torch.engine import checkpoint as ckpt
from proxytransformation_torch.engine.runner import (
    Runner, _DEVICE_KEYS, build_model_from_cfg)
from proxytransformation_torch.engine.train import (
    build_lr_schedule, build_optimizer, make_train_step)
from proxytransformation_torch.models.detector import batch_to_device
from proxytransformation_torch.models.init import flax_init_
from proxytransformation_torch.tools import eval as teval
from proxytransformation_torch.tools import test as ttest
from proxytransformation_torch.tools import train as ttrain_cli

from test_torch_port_runtime_engine import SMOKE, smoke_cfg, two_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------
# the Runner and the CLIs
# --------------------------------------------------------------------------
def test_runner_trains_validates_and_matches_the_train_step(tmp_path):
    """The tiny config, its sets cut to 4 train and 2 val samples: one
    epoch of 2 steps, a checkpoint, val with GroundingMetric; the first
    step against `make_train_step` on the first collated batch, seeded
    weights and generator."""
    cfg = smoke_cfg('train_dataloader.dataset.length=4',
                    'val_dataloader.dataset.length=2')
    runner = Runner(cfg, str(tmp_path), device='cpu')
    runner.train()
    assert [r['iter'] for r in runner.train_log] == [1, 2]
    assert all(np.isfinite(r['total_loss']) for r in runner.train_log)
    assert set(runner.train_timing) == {'iter_s', 'data_wait_s',
                                        'first_wait_s'}
    assert ckpt.list_checkpoints(str(tmp_path)) == ['ckpt_00000002']
    results = (tmp_path / 'val_results.json').read_text()
    assert '"Overall@0.25"' in results and '"Overall@0.5"' in results

    loader = runner._build_loader(cfg['train_dataloader'], True)
    loader.set_epoch(0)
    first = next(iter(loader))
    model = build_model_from_cfg(cfg['model'], 'cpu')
    flax_init_(model, torch.Generator().manual_seed(cfg['seed']))
    opt = build_optimizer(model, base_lr=1e-4)
    step = make_train_step(model, opt, build_lr_schedule(1e-4, len(loader)))
    want = step(batch_to_device({k: v for k, v in first.items()
                                 if k in _DEVICE_KEYS}, 'cpu'),
                torch.Generator().manual_seed(cfg['seed'] + 1))
    got = runner.train_log[0]
    for k, v in want.items():
        assert got[k] == float(v), k


def test_preprocessor_views_follow_each_loaders_pipeline():
    """The flagship's pipelines load 20 train views and 50 ordered eval
    views (through RepeatDataset for train): each loader's collate takes
    its own pipeline's count."""
    from proxytransformation_torch.utils.config import Config
    cfg = Config.fromfile(str(ROOT / 'configs/grounding/'
                              'proxy-tiblock33-gs12-wbias-ddr0.6-clip.py'))
    views = Runner._pipeline_n_views
    assert views(cfg['train_dataloader']['dataset']) == 20
    assert views(cfg['val_dataloader']['dataset']) == 50
    assert views({'type': 'SyntheticGroundingDataset'}) is None


def test_cli_train_test_eval(tmp_path):
    work = str(tmp_path / 'work')
    opts = ['--cfg-options', 'train_dataloader.dataset.length=2',
            'val_dataloader.dataset.length=2']
    runner = ttrain_cli.main([SMOKE, '--device', 'cpu', '--work-dir', work,
                              *opts])
    assert runner.device.type == 'cpu' and runner.global_step == 1
    ckpt_dir = ckpt.latest_checkpoint(work)
    results = ttest.main([SMOKE, ckpt_dir, '--device', 'cpu', '--work-dir',
                          str(tmp_path / 'test'), *opts])
    assert 'Overall@0.25' in results
    again = teval.main([SMOKE, '--resume', ckpt_dir, '--device', 'cpu',
                        '--work-dir', str(tmp_path / 'eval'), *opts])
    assert again == results
    # --amp reaches the model
    runner = ttrain_cli.main([SMOKE, '--device', 'cpu', '--amp',
                              '--work-dir', str(tmp_path / 'amp'), *opts,
                              'train_cfg.max_epochs=0'])
    assert runner.model.compute_dtype == 'bfloat16'
    assert runner.model.remat_painting


# the entry points' `python -m ... --help` and the runtime's import in a
# fresh process (`test_port_runtime_loads_no_forbidden_module`), started
# together by one fixture
HELP_MODULES = ('tools.train', 'tools.test', 'tools.eval', 'tools.eval_script',
                'converter.rscan')


@pytest.fixture(scope='module')
def subprocess_runs():
    """{name: (returncode, stdout, stderr)} of every subprocess check of
    this file, run at once (each bounded by 300 s)."""
    env = dict(os.environ, OMP_NUM_THREADS='2')
    cmds = {m: [sys.executable, '-m', f'proxytransformation_torch.{m}',
                '--help'] for m in HELP_MODULES}
    cmds['runtime_import'] = [sys.executable, '-c', RUNTIME_IMPORT]
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    out = {}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=300)
            out[k] = (p.returncode, o, e)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize('cli', ['train', 'test', 'eval'])
def test_cli_runs_as_a_module(subprocess_runs, cli):
    """`python -m proxytransformation_torch.tools.<cli>` reaches its
    `main` (the run itself is `test_cli_train_test_eval`'s)."""
    rc, out, err = subprocess_runs[f'tools.{cli}']
    assert rc == 0, err[-2000:]
    assert '--device' in out and '--cfg-options' in out


@pytest.mark.parametrize('module,flag', [
    ('tools.eval_script', '--top-k'), ('converter.rscan', '--dataset_folder')])
def test_library_entry_points_run_as_modules(subprocess_runs, module, flag):
    """`python -m` reaches the offline scorer's and the 3RScan
    extractor's `main` (their runs: tests/test_torch_port_library_tools.
    py)."""
    rc, out, err = subprocess_runs[module]
    assert rc == 0, err[-2000:]
    assert flag in out


def test_entry_points_need_a_card_or_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is valid')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Runner(smoke_cfg(), str(tmp_path))
    for main, argv in ((ttrain_cli.main, [SMOKE]), (ttest.main, [SMOKE]),
                       (teval.main, [SMOKE])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main(argv + ['--work-dir', str(tmp_path)])


# --------------------------------------------------------------------------
# import hygiene
# --------------------------------------------------------------------------
FORBIDDEN = {'jax', 'flax', 'proxytransformation_tpu', 'regex', 'cv2',
             'orbax', 'optax', 'PIL', 'imageio', 'open_clip'}
# the fixture writer's OpenCV reference: imported in its `main` only, and
# no module of the runtime imports it
FIXTURE_TOOL = ('proxytransformation_torch/tools/make_image_fixtures.py',
                'main')
# optional packages, each allowed in the guarded scopes that the JAX
# package also has: (file, enclosing class.function) pairs
VIZ = 'proxytransformation_torch/visualization/'
OPTIONAL = {
    'wandb': {('proxytransformation_torch/utils/vis_backend.py',
               'WandbVisBackend.__init__')},
    'transformers': {('proxytransformation_torch/models/text_encoder.py',
                      'HFTokenizerWrapper.__init__')},
    'open3d': {(VIZ + 'utils.py', 'to_open3d_box'),
               (VIZ + 'base_visualizer.py',
                'EmbodiedScanBaseVisualizer.visualize_scene'),
               (VIZ + 'base_visualizer.py',
                'EmbodiedScanBaseVisualizer._render_open3d'),
               (VIZ + 'line_mesh.py', 'LineMesh.to_open3d'),
               (VIZ + 'continuous_drawer.py',
                'ContinuousDrawer.run_interactive')},
    'matplotlib': {(VIZ + 'base_visualizer.py',
                    'EmbodiedScanBaseVisualizer._render_matplotlib')}}


def _imports(path):
    """(top-level module, enclosing class.function) of every import."""
    out = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.ClassDef,
                                  ast.AsyncFunctionDef)):
                visit(child, scope + [child.name])
                continue
            if isinstance(child, ast.Import):
                out.extend((a.name.split('.')[0], '.'.join(scope))
                           for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module.split('.')[0], '.'.join(scope)))
            visit(child, scope)

    visit(ast.parse(path.read_text()), [])
    return out


def test_port_imports_no_jax_or_missing_packages():
    files = sorted((ROOT / 'proxytransformation_torch').rglob('*.py'))
    files.append(ROOT / 'chip_smoke.py')
    seen = set()
    for f in files:
        rel = str(f.relative_to(ROOT))
        for mod, scope in _imports(f):
            if mod == 'cv2' and (rel, scope) == FIXTURE_TOOL:
                continue
            assert mod not in FORBIDDEN, (rel, mod)
            if mod in OPTIONAL:
                assert (rel, scope) in OPTIONAL[mod], (rel, scope, mod)
                seen.add((mod, rel, scope))
    assert seen == {(mod, *where) for mod, scopes in OPTIONAL.items()
                    for where in scopes}


# the modules of the occupancy, TTA and baseline slice
SLICE_MODULES = ('ops/voxelize.py', 'models/occ.py', 'models/tta.py',
                 'eval/occupancy_metric.py', 'converter/occupancy.py')


@pytest.mark.parametrize('module', SLICE_MODULES)
def test_slice_modules_are_guarded(module):
    """Each module is among the files the static guard above walks, and
    imports none of the forbidden packages."""
    path = ROOT / 'proxytransformation_torch' / module
    assert path in set((ROOT / 'proxytransformation_torch').rglob('*.py'))
    assert not {mod for mod, _ in _imports(path)} & FORBIDDEN


# the modules of the text-tower, MinkResNet and parity slice: the towers
# hold upstream checkpoints' layouts without their packages
SLICE13_MODULES = ('models/text_variants.py', 'ops/brick.py',
                   'models/sparse_resnet.py', 'converter/parity.py',
                   'convert.py', 'models/init.py')


@pytest.mark.parametrize('module', SLICE13_MODULES)
def test_slice13_modules_import_no_upstream_package(module):
    """Each module is walked by the static guard, and imports neither the
    JAX side nor transformers or open_clip, at any scope."""
    path = ROOT / 'proxytransformation_torch' / module
    assert path in set((ROOT / 'proxytransformation_torch').rglob('*.py'))
    mods = {mod for mod, _ in _imports(path)}
    assert not mods & (FORBIDDEN | {'transformers', 'open_clip'}), mods


# the modules of the data-parallel slice
SLICE14_MODULES = ('parallel/__init__.py', 'parallel/dist.py',
                   'parallel/gather.py', 'parallel/launch.py')


@pytest.mark.parametrize('module', SLICE14_MODULES)
def test_parallel_modules_import_no_jax(module):
    """Each module of `parallel/` is walked by the static guard and
    imports none of the forbidden packages (its gather keeps its own copy
    of the JAX package's framing)."""
    path = ROOT / 'proxytransformation_torch' / module
    assert path in set((ROOT / 'proxytransformation_torch').rglob('*.py'))
    assert not {mod for mod, _ in _imports(path)} & FORBIDDEN


# the modules of the library slice (structures, the rest of misc.py, the
# raw-data readers, timing, cache, the offline scorer)
SLICE15_MODULES = (
    'structures/rotation.py', 'structures/boxes.py',
    'structures/projection.py', 'structures/modes.py',
    'structures/points.py', 'structures/iou3d_calculator.py',
    'structures/box_np_ops.py', 'structures/transforms.py',
    'models/misc.py', 'utils/timing.py', 'utils/cache.py',
    'converter/scannet_sens.py', 'converter/rscan.py',
    'tools/eval_script.py', 'data/image_io.py')


@pytest.mark.parametrize('module', SLICE15_MODULES)
def test_slice15_modules_import_no_jax(module):
    """Each module is walked by the static guard and imports none of the
    forbidden packages at any scope (the .sens dump writes its PNGs with
    the port's encoder, not cv2)."""
    path = ROOT / 'proxytransformation_torch' / module
    assert path in set((ROOT / 'proxytransformation_torch').rglob('*.py'))
    assert not {mod for mod, _ in _imports(path)} & FORBIDDEN


# the modules of the visualization slice: no cv2 (box wireframes are drawn
# by visualization/raster.py), open3d and matplotlib only in the scopes of
# OPTIONAL
SLICE16_MODULES = (
    'visualization/__init__.py', 'visualization/utils.py',
    'visualization/color_selector.py', 'visualization/raster.py',
    'visualization/img_drawer.py', 'visualization/line_mesh.py',
    'visualization/base_visualizer.py', 'visualization/continuous_drawer.py',
    'explorer.py')


@pytest.mark.parametrize('module', SLICE16_MODULES)
def test_slice16_modules_import_no_cv2_or_jax(module):
    """Each module is walked by the static guard, imports none of the
    forbidden packages at any scope, and imports open3d and matplotlib
    only inside the functions that render with them."""
    path = ROOT / 'proxytransformation_torch' / module
    assert path in set((ROOT / 'proxytransformation_torch').rglob('*.py'))
    rel = str(path.relative_to(ROOT))
    for mod, scope in _imports(path):
        assert mod not in FORBIDDEN, (mod, scope)
        if mod in ('open3d', 'matplotlib'):
            assert (rel, scope) in OPTIONAL[mod], (mod, scope)


# the data path too: a JPEG and a PNG view through the host decoder
RUNTIME_IMPORT = (
    'import sys, proxytransformation_torch.tools.train, '
    'proxytransformation_torch.tools.test, '
    'proxytransformation_torch.tools.eval, '
    'proxytransformation_torch.tools.make_image_fixtures, '
    'proxytransformation_torch.converter.occupancy, '
    'proxytransformation_torch.models.occ, '
    'proxytransformation_torch.models.tta, '
    'proxytransformation_torch.models.text_variants, '
    'proxytransformation_torch.converter.parity, '
    'proxytransformation_torch.ops.brick, '
    'proxytransformation_torch.tools.eval_script, '
    'proxytransformation_torch.converter.scannet_sens, '
    'proxytransformation_torch.converter.rscan, '
    'proxytransformation_torch.models.misc, '
    'proxytransformation_torch.utils.timing, '
    'proxytransformation_torch.utils.cache, '
    'proxytransformation_torch.visualization, '
    'proxytransformation_torch.visualization.raster, '
    'proxytransformation_torch.explorer, '
    + ', '.join(f'proxytransformation_torch.structures.{m}' for m in (
        'rotation', 'boxes', 'projection', 'modes', 'points',
        'iou3d_calculator', 'box_np_ops', 'transforms')) + '; '
    'from proxytransformation_torch.data import image_io; '
    'image_io.imread("tests/torch_port_images/view0_640x480.jpg"); '
    'image_io.imread("tests/torch_port_images/depth0_640x480.png", -1); '
    'print(sorted({m.split(".")[0] for m in sys.modules}))')


def test_port_runtime_loads_no_forbidden_module(subprocess_runs):
    rc, out, err = subprocess_runs['runtime_import']
    assert rc == 0, err[-2000:]
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | set(OPTIONAL)), loaded & FORBIDDEN


def test_flagship_batch_keys_are_device_keys():
    """Every key a batch carries to the device is one the Runner moves."""
    assert set(flagship_batch(B=1, n_points=8, V=1, H=32, W=32, L=4,
                              with_targets=True)) <= set(_DEVICE_KEYS)
