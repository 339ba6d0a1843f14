"""The data-parallel Runner through the port's CLIs, on the CPU.

`tools.train configs/grounding/synthetic_smoke.py --launcher pytorch
--device cpu` on 2 gloo ranks (two `python -m` processes with torchrun's
environment, a `file://` rendezvous in the test's directory, a 60 s
process-group timeout, two torch threads each, every wait bounded): one
epoch of 4 steps at the config's B=2 (1 a rank) with a mid-epoch
checkpoint, written by rank 0 alone; its `val_results.json` equal to the
one-process run's; `--resume auto` from the mid-epoch checkpoint
bit-equal to the uninterrupted 2-rank run; `tools.test` on 2 ranks
dumping the same boxes in the same order as on one process; the same
epoch started through `--launcher slurm` from SLURM's environment (two
tasks on one node, a `tcp://` rendezvous at `MASTER_PORT`) bit-equal to
the `--launcher pytorch` run. And what raises: a batch the ranks do not
divide, NCCL with two ranks on one device or on the CPU, `--launcher
slurm` / `mpi` without their environment. Occupancy on 2 ranks
(both predictors through the Runner, in the spawn that checks what
raises) against one process: the step to float32 rounding, the ranks'
states bit-equal, val_results.json equal.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from proxytransformation_torch.tools import eval as teval
from proxytransformation_torch.tools import test as ttest
from proxytransformation_torch.tools import train as ttrain_cli

import torch_port_dp_workers as workers

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / 'configs/grounding/synthetic_smoke.py')
OCC_SMOKE = str(ROOT / 'configs/occupancy/synthetic_smoke.py')
WORLD = 2
# the mid-epoch checkpoint after 2 of the epoch's 4 steps
MID = ['checkpoint_interval_iters=2']
DUMP = ["val_evaluator={'type': 'GroundingMetric', 'format_only': True}"]


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def start(tool, args, options, tmp, world=WORLD, launcher='pytorch'):
    """`tools.<tool> args --launcher pytorch --device cpu` started on
    `world` gloo ranks (a rendezvous file of its own in `tmp`); returns
    the rank processes for `finish`. `launcher='slurm'`: the ranks are
    the tasks of a one-node SLURM step instead, meeting over tcp:// at
    localhost's MASTER_PORT."""
    rdv = Path(tempfile.mkdtemp(prefix=f'{tool}_', dir=tmp)) / 'rendezvous'
    port = free_port()
    procs = []
    for rank in range(world):
        if launcher == 'slurm':
            ranks = dict(SLURM_JOB_ID='4182391',
                         SLURM_STEP_NODELIST='localhost',
                         SLURM_NTASKS=str(world), SLURM_PROCID=str(rank),
                         SLURM_LOCALID=str(rank), SLURM_STEP_NUM_NODES='1',
                         SLURM_NODEID='0', MASTER_PORT=str(port))
            meet = []
        else:
            ranks = dict(RANK=str(rank), WORLD_SIZE=str(world),
                         LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                         GROUP_RANK='0')
            meet = [f'env_cfg.dist_cfg.init_method=file://{rdv}']
        env = dict(os.environ, OMP_NUM_THREADS='2', MKL_NUM_THREADS='2',
                   **ranks)
        cmd = [sys.executable, '-m', f'proxytransformation_torch.tools.{tool}',
               *args, '--launcher', launcher, '--device', 'cpu',
               '--cfg-options', 'env_cfg.dist_cfg.backend=gloo', *meet,
               'env_cfg.dist_cfg.timeout=60', *options]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def finish(procs, timeout=240):
    """Each rank's stderr once all have ended; any rank failing, or still
    running after `timeout` seconds (then killed), fails the call."""
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=timeout)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f'rank {rank}:\n{err[-3000:]}'
    return errs


def state_of(work, ckpt):
    return torch.load(Path(work) / ckpt / 'state.pth', weights_only=True)


def same(a, b, what=''):
    """Nested payloads equal bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            same(a[k], b[k], f'{what}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f'{what}[{i}]')
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The one-process runs overlap the 2-rank launches they are held
    against (each launch's ranks start up while this process trains or
    tests)."""
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp('dp_runner')
    one, two, resumed = tmp / 'one', tmp / 'two', tmp / 'resumed'
    slurm = tmp / 'slurm'
    train_two = start('train', [SMOKE, '--work-dir', str(two)], MID, tmp)
    train_slurm = start('train', [SMOKE, '--work-dir', str(slurm)], MID, tmp,
                        launcher='slurm')
    try:
        ttrain_cli.main([SMOKE, '--device', 'cpu', '--work-dir', str(one)])
    finally:
        try:
            train_err = finish(train_two)
        finally:
            finish(train_slurm)
    resumed.mkdir()
    shutil.copytree(two / 'ckpt_00000002', resumed / 'ckpt_00000002')
    # the same checkpoint tested on 2 ranks and on one, the boxes dumped
    ckpt = str(two / 'ckpt_00000004')
    resume = start('train', [SMOKE, '--work-dir', str(resumed), '--resume',
                             'auto'], MID, tmp)
    test_two = start('test', [SMOKE, ckpt, '--work-dir',
                              str(tmp / 'test_two')], DUMP, tmp)
    try:
        ttest.main([SMOKE, ckpt, '--device', 'cpu', '--work-dir',
                    str(tmp / 'test_one'), '--cfg-options', *DUMP])
    finally:
        try:
            finish(resume)
        finally:
            finish(test_two)
    return dict(tmp=tmp, one=one, two=two, resumed=resumed, slurm=slurm,
                train_err=train_err)


def test_dp_runner_writes_one_checkpoint_series_from_rank_0(runs):
    """The mid-epoch and the epoch's checkpoint, each saved by rank 0
    alone (the other rank logs no save), with the 2-rank run's step and
    epoch counts."""
    assert sorted(os.listdir(runs['two'])) == [
        'ckpt_00000002', 'ckpt_00000004', 'scalars.jsonl',
        'val_results.json']
    rank0, rank1 = runs['train_err']
    assert rank0.count('saved checkpoint') == 2
    assert 'saved checkpoint' not in rank1
    assert 'iter 4/4' in rank0 and 'iter 4/4' not in rank1
    payload = state_of(runs['two'], 'ckpt_00000004')
    assert (payload['step'], payload['epoch'], payload['iteration']) == (
        4, 1, 0)
    assert state_of(runs['two'], 'ckpt_00000002')['iteration'] == 2


def test_dp_runner_val_results_equal_the_one_process_run(runs):
    got = json.loads((runs['two'] / 'val_results.json').read_text())
    want = json.loads((runs['one'] / 'val_results.json').read_text())
    assert got == want and 'Overall@0.25' in got


def test_dp_runner_trains_what_one_process_trains(runs):
    """The 2-rank epoch's first logged losses equal the one-process run's
    (the same global batches): the scalars of step 1."""
    def first(work):
        return json.loads((work / 'scalars.jsonl').read_text()
                          .splitlines()[0])
    got, want = first(runs['two']), first(runs['one'])
    for k in ('total_loss', 'grad_norm', 'loss_cls', 'loss_bbox'):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_dp_resume_auto_is_bit_equal_to_the_uninterrupted_run(runs):
    """`--resume auto` from the mid-epoch checkpoint on 2 ranks: the
    epoch's checkpoint (parameters, running statistics, AdamW state,
    generator, counters) and val results equal the uninterrupted run's,
    bit for bit."""
    same(state_of(runs['resumed'], 'ckpt_00000004'),
         state_of(runs['two'], 'ckpt_00000004'), 'state')
    assert (json.loads((runs['resumed'] / 'val_results.json').read_text())
            == json.loads((runs['two'] / 'val_results.json').read_text()))


def test_dp_slurm_launch_trains_what_the_pytorch_launch_trains(runs):
    """The epoch through `--launcher slurm` (two tasks of a one-node step,
    tcp:// at MASTER_PORT): both checkpoints and the val results equal
    the `--launcher pytorch` run's, bit for bit."""
    for ckpt in ('ckpt_00000002', 'ckpt_00000004'):
        same(state_of(runs['slurm'], ckpt), state_of(runs['two'], ckpt),
             ckpt)
    assert (json.loads((runs['slurm'] / 'val_results.json').read_text())
            == json.loads((runs['two'] / 'val_results.json').read_text()))


def test_dp_test_cli_dumps_the_one_process_boxes_in_loader_order(runs):
    """tools.test on 2 ranks (val's batches dealt in turn, gathered back
    for rank 0's dump) writes the one-process test_results.json."""
    got = json.loads((runs['tmp'] / 'test_two' / 'test_results.json')
                     .read_text())
    want = json.loads((runs['tmp'] / 'test_one' / 'test_results.json')
                      .read_text())
    assert len(got) == 4
    assert got == want


# --------------------------------------------------------------------------
# what raises
# --------------------------------------------------------------------------
OCC_TYPES = ('EmbodiedOccPredictor', 'DenseFusionOccPredictor')
OCC_B = 4


def _occ_cfgs(tmp):
    """Each occupancy model on the smoke config at a global train batch of
    OCC_B (its dataset cut to one batch: one step), val a scene a batch."""
    return {mtype: (OCC_SMOKE, [f'model.type={mtype!r}',
                                f'train_dataloader.batch_size={OCC_B}',
                                f'train_dataloader.dataset.length={OCC_B}',
                                'val_dataloader.batch_size=1'],
                    str(tmp / mtype))
            for mtype in OCC_TYPES}


@pytest.fixture(scope='module')
def rank_jobs(tmp_path_factory):
    """One spawn of 2 ranks: what raises, then both occupancy models
    through the Runner (`workers.occupancy_runs`); and, while the ranks
    work, the occupancy runs in this process at B=OCC_B."""
    tmp = tmp_path_factory.mktemp('dp_ranks')
    torch.set_num_threads(2)
    cfgs = {'batch': (SMOKE, ['train_dataloader.batch_size=3'],
                      str(tmp / 'batch'))}
    jobs = [('raises', workers.raises, (cfgs, )),
            ('occupancy', workers.occupancy_runs,
             (_occ_cfgs(tmp / 'occ_two'), ))]
    handle = workers.start_ranks(workers.run_jobs, WORLD, tmp / 'ranks',
                                 jobs)
    try:
        one = workers.occupancy_runs(None, _occ_cfgs(tmp / 'occ_one'))
    finally:
        ranks = workers.join_ranks(handle, timeout=480.0)
    return dict(ranks=ranks, one=one)


@pytest.fixture(scope='module')
def rank_raises(rank_jobs):
    return [r['raises'] for r in rank_jobs['ranks']]


def test_dp_raises_on_a_batch_the_ranks_do_not_divide(rank_raises):
    for r in rank_raises:
        assert r['batch'].startswith('ValueError')
        assert 'batch_size=3' in r['batch'] and '2 ranks' in r['batch']


def test_dp_raises_on_occupancy(rank_jobs):
    """Occupancy no longer raises at world size 2: both models train a
    step and validate on both ranks (held against one process below)."""
    for r in rank_jobs['ranks']:
        assert set(r['occupancy']) == set(OCC_TYPES)
        for run in r['occupancy'].values():
            assert run['metrics'] and run['val_results']


# --------------------------------------------------------------------------
# occupancy on 2 ranks against one process
# --------------------------------------------------------------------------
# Both models' step at a global batch of 4 (2 rows a rank) against this
# process's at B=4. The batch-coupled reductions are the ImVoxel neck's
# train-mode flax norms (the sums all-reduced) and each scale's batch mean
# of per-sample losses (equal slices: the rank mean is the global mean);
# the affinity losses and DenseFusion's dense scatter are per sample, the
# 2D ResNet's norms folded. No discrete choice, so the step agrees to
# float32 rounding: losses and grad_norm within 1e-6 relative; every
# gradient within 1e-5 of its tensor's max plus 1e-7 of the gradient norm
# (a tensor whose gradients sit at rounding level); the running statistics
# within 1e-6 · (1 + max); both ranks' states bit-equal; val's scenes dealt
# to the ranks and gathered back: val_results.json equal.
# (tests/test_torch_port_occupancy.py holds the one process against the
# JAX Runner.)
@pytest.mark.parametrize('mtype', OCC_TYPES)
def test_dp_occupancy_step_matches_one_process(rank_jobs, mtype):
    want = rank_jobs['one'][mtype]
    got = rank_jobs['ranks'][0]['occupancy'][mtype]
    assert (want['rows'], got['rows']) == (OCC_B, OCC_B // WORLD)
    assert set(got['metrics']) == set(want['metrics']) >= {
        'loss_occ_0', 'loss_occ_1', 'loss_occ_2', 'total_loss', 'grad_norm'}
    for k, w in want['metrics'].items():
        assert abs(got['metrics'][k] - w) <= 1e-6 * abs(w), (
            k, got['metrics'][k], w)
    assert set(got['grads']) == set(want['grads'])
    gn = want['metrics']['grad_norm']
    for k, w in want['grads'].items():
        err = np.abs(got['grads'][k] - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-7 * gn, (k, err)
    stats = [k for k in want['state'] if 'running' in k]
    assert stats
    for k in stats:
        w = want['state'][k]
        err = np.abs(got['state'][k] - w).max()
        assert err <= 1e-6 * (1 + np.abs(w).max()), (k, err)


@pytest.mark.parametrize('mtype', OCC_TYPES)
def test_dp_occupancy_ranks_hold_the_same_state(rank_jobs, mtype):
    r0, r1 = (r['occupancy'][mtype] for r in rank_jobs['ranks'])
    assert r0['metrics'] == r1['metrics']
    for k, v in r0['state'].items():
        assert np.array_equal(v, r1['state'][k]), k


@pytest.mark.parametrize('mtype', OCC_TYPES)
def test_dp_occupancy_val_results_equal_one_process(rank_jobs, mtype):
    want = rank_jobs['one'][mtype]['val_results']
    assert 'mIoU' in want and 'IoU_geo' in want
    for r in rank_jobs['ranks']:
        assert r['occupancy'][mtype]['val_results'] == want


def _torchrun_env(monkeypatch, world=2, rank=0):
    for k, v in dict(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                     LOCAL_WORLD_SIZE=world, GROUP_RANK=0).items():
        monkeypatch.setenv(k, str(v))


@pytest.mark.parametrize('device', ['cuda:0', 'cpu'])
def test_nccl_refuses_two_ranks_on_one_device(monkeypatch, tmp_path,
                                              device):
    """The default backend (nccl) with one named device for a node's two
    ranks, or on the CPU: raises naming the backend option, before any
    process group exists."""
    _torchrun_env(monkeypatch)
    with pytest.raises(ValueError, match='env_cfg.dist_cfg.backend=gloo'):
        ttrain_cli.main([SMOKE, '--launcher', 'pytorch', '--device', device,
                         '--work-dir', str(tmp_path)])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize('launcher', ['slurm', 'mpi'])
@pytest.mark.parametrize('cli', [ttrain_cli, ttest, teval])
def test_launchers_other_than_pytorch_raise(monkeypatch, tmp_path, cli,
                                            launcher):
    """`--launcher slurm` / `mpi` outside srun / mpirun: every CLI raises
    naming the first variable it misses, before any process group
    exists (no fallback to one process)."""
    for k in ('SLURM_JOB_ID', 'OMPI_MCA_orte_hnp_uri'):
        monkeypatch.delenv(k, raising=False)
    first = {'slurm': 'SLURM_JOB_ID', 'mpi': 'OMPI_MCA_orte_hnp_uri'}
    with pytest.raises(RuntimeError,
                       match=f'--launcher {launcher}: .*{first[launcher]}'):
        cli.main([SMOKE, '--launcher', launcher, '--device', 'cpu',
                  '--work-dir', str(tmp_path)])
    assert not torch.distributed.is_initialized()
