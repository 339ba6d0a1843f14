"""The port's data parallelism (`proxytransformation_torch/parallel/`)
against the one-process run and the JAX package's sharded step, on the
CPU.

The JAX package's step is one `jit` over a batch sharded on a `data`
mesh, so it computes the one-device function of the global batch. The
port's ranks must do the same: two gloo ranks (spawned processes, a
`file://` rendezvous, a 60 s process-group timeout, two torch threads
each; `torch_port_dp_workers.py`) each take an equal slice of the
global batch.

- The host-object gather and its framing, the loader's node shards and
  rank slices against the JAX `DataLoader`'s batches, val's deal over the
  ranks and its gather back into loader order.
- The flax and masked train-mode BatchNorms on 2 ranks against one
  process on the concatenated batch: outputs, input and weight
  gradients, running statistics on both ranks.
- The grounding head's and the FCAF3D head's losses and gradients.
- The milestone: the tiny grounder of tests/test_torch_port_train.py
  takes two AdamW steps at global B=4 on 2 ranks with the injected
  global dropout masks, held against the JAX step on the same batch
  sharded over 2 of conftest's CPU devices (`shard_batch`, the JAX
  package's own data parallelism) with that file's tolerances, the
  second step from the JAX package's state after the first (at this
  batch the one-process port's free-running second step is itself
  2.2e-2 off JAX's in loss_bbox: Adam moves entries whose gradient is
  at rounding level by ±lr), and against the port's one-process step,
  free-running, to float32 rounding; both ranks hold the same state.
- The tiny detector's step on 2 ranks against its one-process step.

A rank's input gradients (a norm's x, the head's inputs) are the world
size times the one-process global loss's: each rank's loss is its part
of the global loss times the world size (local_sum over the synced
count / world), and the rank mean of the weight gradients is the global
loss's gradient.
"""
import contextlib
import copy

import numpy as np
import pytest
import torch

from proxytransformation_tpu.data.loader import DataLoader as JDataLoader
from proxytransformation_tpu.parallel import gather as jgather
from proxytransformation_tpu.parallel import make_mesh
from proxytransformation_torch.data.loader import DataLoader
from proxytransformation_torch.models.fcaf3d_head import FCAF3DHead
from proxytransformation_torch.models.grounding_head import GroundingHead
from proxytransformation_torch.models.norms import BatchNormParams
from proxytransformation_torch.parallel import gather, world_size

import torch_port_dp_workers as workers
from test_detector import tiny_batch
from test_torch_port_detection import TINY_DET, det_batch
from test_torch_port_detector import TINY, tiny_state_dict
from test_torch_port_train import (_grad_tol, run_jax, run_port)

WORLD = 2
KEEP = 0.8


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, what='', rel=1e-6):
    """|got - want| <= rel · (1 + max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    tol = rel * (1 + (np.abs(want).max() if want.size else 0.0))
    assert err <= tol, (what, err, tol)


def cat(parts, axis=0):
    return np.concatenate([np.asarray(p) for p in parts], axis)


# --------------------------------------------------------------------------
# the small checks: one spawn of 2 ranks
# --------------------------------------------------------------------------
def _norm_inputs(kind, rng):
    C = 6
    shape = (4, 5, 3, C) if kind == 'flax' else (4, 40, C)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    mask = rng.rand(*shape[:-1]) < 0.7
    params = {'weight': (rng.rand(C) + 0.5).astype(np.float32),
              'bias': rng.randn(C).astype(np.float32),
              'running_mean': rng.randn(C).astype(np.float32),
              'running_var': (rng.rand(C) + 0.5).astype(np.float32)}
    cot = rng.randn(*shape).astype(np.float32)
    return x, mask, params, cot


def _grounding_inputs(rng):
    L, B, Q, C, T, M, G = 2, 4, 12, 16, 6, 8, 3
    head = GroundingHead(embed_dims=C, max_text_len=M)
    torch.manual_seed(0)
    for p in head.parameters():
        torch.nn.init.normal_(p, std=0.3)
    gt = np.concatenate([rng.uniform(0.5, 2.5, (B, G, 3)),
                         rng.uniform(0.3, 1.0, (B, G, 3)),
                         rng.uniform(-0.5, 0.5, (B, G, 3))], -1)
    boxes = np.concatenate([rng.uniform(0.5, 2.5, (L, B, Q, 3)),
                            rng.uniform(0.3, 1.0, (L, B, Q, 3)),
                            rng.uniform(-0.5, 0.5, (L, B, Q, 3))], -1)
    pos_maps = np.zeros((B, G, M), np.float32)
    pos_maps[..., 1] = 1.0
    pos_maps[:, 1, 2] = 1.0
    return dict(
        C=C, M=M, state={k: v.detach().numpy().copy()
                         for k, v in head.state_dict().items()},
        hidden=rng.randn(L, B, Q, C).astype(np.float32),
        boxes=boxes.astype(np.float32),
        text_feats=rng.randn(B, T, C).astype(np.float32),
        text_mask=np.arange(T)[None].repeat(B, 0) < np.array(
            [[T], [T - 1], [T - 2], [T]]),
        gt=gt.astype(np.float32),
        gt_masks=np.arange(G)[None].repeat(B, 0) < np.array(
            [[1], [3], [2], [3]]),
        pos_maps=pos_maps, query_mask=rng.rand(B, Q) < 0.85)


def _fcaf3d_inputs(rng):
    B, per_level, C, G = 4, 30, 5, 3
    kw = dict(num_classes=C, in_channels=(8, 16, 32, 64), out_channels=8,
              pts_assign_threshold=4, pts_center_threshold=3)
    P = 4 * per_level
    gt = np.concatenate([rng.uniform(0.8, 2.2, (B, G, 3)),
                         rng.uniform(0.8, 1.6, (B, G, 3)),
                         rng.uniform(-0.3, 0.3, (B, G, 3))], -1)
    bboxes = np.concatenate([rng.uniform(0.1, 0.8, (B, P, 6)),
                             rng.uniform(-0.3, 0.3, (B, P, 3))], -1)
    return dict(
        kw=kw, centers=rng.randn(B, P, 1).astype(np.float32),
        bboxes=bboxes.astype(np.float32),
        clses=rng.randn(B, P, C).astype(np.float32),
        points=rng.uniform(0.5, 2.5, (B, P, 3)).astype(np.float32),
        masks=rng.rand(B, P) < 0.9,
        level_ids=np.repeat(np.arange(4), per_level),
        gt_bboxes=gt.astype(np.float32),
        gt_labels=rng.randint(0, C, (B, G)).astype(np.int64),
        gt_mask=np.arange(G)[None].repeat(B, 0) < np.array(
            [[3], [2], [3], [1]]))


def _one_process_norm(kind, x, mask, params, cot):
    bn = BatchNormParams(x.shape[-1])
    with torch.no_grad():
        for name, v in params.items():
            getattr(bn, name).copy_(torch.from_numpy(v))
    xt = torch.tensor(x, requires_grad=True)
    y = (bn.flax(xt, train=True) if kind == 'flax'
         else bn.masked(xt, torch.from_numpy(mask), train=True))
    (torch.sum(y * torch.from_numpy(cot)) / x.shape[0]).backward()
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(),
                dw=bn.weight.grad.numpy(), db=bn.bias.grad.numpy(),
                running_mean=bn.running_mean.numpy(),
                running_var=bn.running_var.numpy())


def _one_process_grounding(case):
    head = GroundingHead(embed_dims=case['C'], max_text_len=case['M'])
    head.load_state_dict({k: torch.from_numpy(v)
                          for k, v in case['state'].items()})
    hidden = torch.tensor(case['hidden'], requires_grad=True)
    boxes = torch.tensor(case['boxes'], requires_grad=True)
    t = {k: torch.from_numpy(case[k]) for k in (
        'text_feats', 'text_mask', 'gt', 'gt_masks', 'pos_maps',
        'query_mask')}
    losses = head.loss(hidden, boxes, t['text_feats'], t['text_mask'],
                       t['gt'], t['gt_masks'], t['pos_maps'],
                       t['query_mask'])
    sum(losses[k] for k in sorted(losses)).backward()
    return dict(losses={k: float(v) for k, v in losses.items()},
                dhidden=hidden.grad.numpy(), dboxes=boxes.grad.numpy(),
                grads={n: p.grad.numpy() for n, p in head.named_parameters()
                       if p.grad is not None})


def _one_process_fcaf3d(case):
    head = FCAF3DHead(**case['kw'])
    leaves = {k: torch.tensor(case[k], requires_grad=True)
              for k in ('centers', 'bboxes', 'clses')}
    outs = (leaves['centers'], leaves['bboxes'], leaves['clses'],
            torch.from_numpy(case['points']), torch.from_numpy(case['masks']),
            torch.from_numpy(case['level_ids']))
    losses = head.loss(outs, torch.from_numpy(case['gt_bboxes']),
                       torch.from_numpy(case['gt_labels']),
                       torch.from_numpy(case['gt_mask']))
    sum(losses[k] for k in sorted(losses)).backward()
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads={k: v.grad.numpy() for k, v in leaves.items()})


@contextlib.contextmanager
def reference_state():
    """The process state this file's one-process and JAX references run
    in, set here instead of inherited from the test files an xdist worker
    ran before: two torch threads, denormals not flushed, float32 as the
    default dtype, torch's and numpy's global generators seeded 0; all
    restored on exit."""
    saved = (torch.get_num_threads(), torch.get_default_dtype(),
             torch.random.get_rng_state(), np.random.get_state())
    torch.set_num_threads(2)
    torch.set_flush_denormal(False)
    torch.set_default_dtype(torch.float32)
    torch.manual_seed(0)
    np.random.seed(0)
    try:
        yield
    finally:
        torch.set_num_threads(saved[0])
        torch.set_default_dtype(saved[1])
        torch.random.set_rng_state(saved[2])
        np.random.set_state(saved[3])


@pytest.fixture(scope='module')
def rank_runs(tmp_path_factory):
    """Every 2-rank run of this file in one spawn (`workers.run_jobs`):
    the small checks, the grounder's free-running steps and its second
    step from the JAX package's state, and the detector's steps; their
    inputs and the JAX records come first, and the one-process runs they
    are held against run here while the ranks work, in `reference_state`
    and each on its own deep copy of its inputs (no run can change what
    another reads)."""
    with reference_state():
        return _rank_runs(tmp_path_factory)


def _rank_runs(tmp_path_factory):
    rng = np.random.RandomState(0)
    cases = {kind: _norm_inputs(kind, rng) for kind in ('flax', 'masked')}
    cases['grounding'] = _grounding_inputs(rng)
    cases['fcaf3d'] = _fcaf3d_inputs(rng)
    sd = tiny_state_dict()
    batch = global_batch()
    mp = pytest.MonkeyPatch()
    try:
        want, masks, jseen = run_jax(*copy.deepcopy((sd, batch)), 2, mp,
                                     mesh=make_mesh(WORLD))
    finally:
        mp.undo()
    parts = [det_batch(seed) for seed in (0, 1)]
    det = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    det_one = workers.detector_steps(None, TINY_DET, copy.deepcopy(det))
    jobs = [('small', workers.small_checks, (cases, )),
            ('free', workers.grounder_steps, (TINY, sd, batch, masks, 2)),
            # the second step again, from the JAX package's state after
            # the first
            ('forced', workers.grounder_steps,
             (TINY, want[0]['state'], batch, masks, 1, want[0])),
            # the ranks' first detector step, then their second from the
            # one-process state after the first
            ('detector', workers.detector_steps,
             (TINY_DET, det, det_one[0]['resume']))]
    handle = workers.start_ranks(workers.run_jobs, WORLD,
                                 tmp_path_factory.mktemp('ranks'), jobs)
    try:
        cases = copy.deepcopy(cases)
        one = {kind: _one_process_norm(kind, *cases[kind])
               for kind in ('flax', 'masked')}
        one['grounding'] = _one_process_grounding(cases['grounding'])
        one['fcaf3d'] = _one_process_fcaf3d(cases['fcaf3d'])
        grounder, one_seen, _, _ = run_port(
            *copy.deepcopy((sd, batch, masks)), 2)
        forced, _, _, _ = run_port(
            *copy.deepcopy((want[0]['state'], batch, masks)), 1,
            adam=copy.deepcopy(want[0]))
    finally:
        ranks = workers.join_ranks(handle, timeout=600.0)
    return dict(ranks=ranks, one=one, sd=sd, want=want, masks=masks,
                jseen=jseen, grounder=grounder, one_seen=one_seen,
                forced=forced[0], det_one=det_one)


@pytest.fixture(scope='module')
def small(rank_runs):
    return dict(ranks=[r['small'] for r in rank_runs['ranks']],
                one=rank_runs['one'])


def test_allgather_objects_round_trip_and_order(small):
    """Every rank gets every rank's objects in rank order; the framing is
    the JAX package's byte for byte; rank 0's object is broadcast."""
    want = [('rank', 0, 0), ('rank', 1, 0), ('rank', 1, 1)]
    for r in small['ranks']:
        assert r['allgather'] == want
        assert r['broadcast'] == {'from': 0}
    objs = [{'a': np.arange(3)}, 'b', (1, 2.5)]
    buf = gather.pack_objects(objs)
    assert bytes(buf) == bytes(jgather.pack_objects(objs))
    padded = np.concatenate([buf, np.zeros(9, np.uint8)])
    got = gather.unpack_objects(padded, buf.size)
    assert got[1:] == objs[1:] and np.array_equal(got[0]['a'], objs[0]['a'])
    # one process: the identity, no process group
    assert world_size() == 1
    assert gather.allgather_objects(objs) is not objs
    assert gather.allgather_objects(objs)[1:] == objs[1:]


@pytest.mark.parametrize('kind', ['flax', 'masked'])
def test_norm_on_two_ranks_matches_the_concatenated_batch(small, kind):
    """Outputs, input gradients (over the world size) and weight
    gradients equal the one-process norm's on the concatenated batch, and
    both ranks' running statistics equal it (float32, 1e-6·(1 + max))."""
    ranks, one = small['ranks'], small['one'][kind]
    close(cat([r[kind]['y'] for r in ranks]), one['y'], 'y')
    close(cat([r[kind]['dx'] for r in ranks]) / WORLD, one['dx'], 'dx')
    for r in ranks:
        for key in ('dw', 'db', 'running_mean', 'running_var'):
            close(r[kind][key], one[key], key)
    for key in ('dw', 'db', 'running_mean', 'running_var'):
        assert np.array_equal(ranks[0][kind][key], ranks[1][kind][key]), key


def test_grounding_loss_gradients_match_one_process(small):
    """The synced normalisers (`cls_avg`, `np_sync`): rank-mean losses and
    rank-mean parameter gradients equal the one-process global loss's;
    the inputs' gradients are the world size times its rows."""
    one = small['one']['grounding']
    for r in small['ranks']:
        g = r['grounding']
        assert set(g['losses']) == set(one['losses'])
        for k, v in one['losses'].items():
            close(g['losses'][k], v, k)
        assert set(g['grads']) == set(one['grads']) == {
            'cls_branches.0.bias'}
        for k, v in one['grads'].items():
            close(g['grads'][k], v, k)
    ranks = [r['grounding'] for r in small['ranks']]
    close(cat([r['dhidden'] for r in ranks], 1) / WORLD, one['dhidden'],
          'dhidden')
    close(cat([r['dboxes'] for r in ranks], 1) / WORLD, one['dboxes'],
          'dboxes')


def test_fcaf3d_loss_gradients_match_one_process(small):
    """The FCAF3D head's per-sample normalisers stay local (the JAX head
    computes them in its per-sample vmap) and its batch mean is the
    global one over equal slices: rank-mean losses equal the one-process
    losses, the head outputs' gradients the world size times its rows."""
    one = small['one']['fcaf3d']
    for r in small['ranks']:
        for k, v in one['losses'].items():
            close(r['fcaf3d']['losses'][k], v, k)
    for k, v in one['grads'].items():
        close(cat([r['fcaf3d']['grads'][k] for r in small['ranks']])
              / WORLD, v, k)


def test_val_deal_and_gather_give_loader_order(small):
    """Seven samples in batches of 2 dealt to 2 ranks in turn: rank 0
    predicts batches 0 and 2, rank 1 batches 1 and 3 (the partial one),
    and the gather gives every rank the loader's order."""
    mine = [r['val_deal']['mine'] for r in small['ranks']]
    assert mine == [[0, 1, 4, 5], [2, 3, 6]]
    for r in small['ranks']:
        assert r['val_deal']['gathered'] == list(range(7))


# --------------------------------------------------------------------------
# the loader's node shards and rank slices (no process group needed)
# --------------------------------------------------------------------------
def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return [np.asarray(b) for b in loader]


@pytest.mark.parametrize('shuffle', [True, False])
@pytest.mark.parametrize('nodes,local', [(1, 2), (2, 1), (2, 2)])
def test_loader_rank_slices_equal_the_jax_host_batches(shuffle, nodes,
                                                       local):
    """Three epochs of a 19-sample set in node batches of 4 (drop_last):
    a node's ranks' slices, side by side, are the JAX DataLoader's
    batches for that host (`num_shards` nodes, `shard_id` the node)."""
    data = list(range(19))
    for node in range(nodes):
        jax_loader = JDataLoader(data, 4, np.asarray, shuffle=shuffle,
                                 seed=3, drop_last=True, num_shards=nodes,
                                 shard_id=node)
        ranks = [DataLoader(data, 4, np.asarray, shuffle=shuffle, seed=3,
                            drop_last=True, num_shards=nodes, shard_id=node,
                            rank_slice=(r, local)) for r in range(local)]
        for epoch in range(3):
            want = _batches(jax_loader, epoch)
            got = [_batches(loader, epoch) for loader in ranks]
            assert all(len(g) == len(want) == len(loader)
                       for g, loader in zip(got, ranks))
            for i, w in enumerate(want):
                np.testing.assert_array_equal(
                    np.concatenate([g[i] for g in got]), w)


@pytest.mark.parametrize('shuffle', [True, False])
def test_loader_node_shards_keep_partial_batches(shuffle):
    """drop_last off (val): each node's shard is the JAX host's, the last
    batch partial."""
    data = list(range(11))
    for node in range(2):
        want = _batches(JDataLoader(data, 4, np.asarray, shuffle=shuffle,
                                    drop_last=False, num_shards=2,
                                    shard_id=node), 1)
        got = _batches(DataLoader(data, 4, np.asarray, shuffle=shuffle,
                                  drop_last=False, num_shards=2,
                                  shard_id=node), 1)
        assert [b.tolist() for b in got] == [b.tolist() for b in want]


def test_loader_refuses_a_batch_the_ranks_do_not_divide():
    with pytest.raises(ValueError, match=r'batch_size=3 .* 2 ranks'):
        DataLoader(list(range(8)), 3, np.asarray, rank_slice=(0, 2))


# --------------------------------------------------------------------------
# the milestone: two AdamW steps of the tiny grounder at global B=4
# --------------------------------------------------------------------------
def global_batch():
    """B=4: two of tests/test_detector.py's B=2 batches."""
    parts = [tiny_batch(np.random.RandomState(seed), L=8) for seed in (1, 2)]
    return {k: np.concatenate([np.asarray(p[k]) for p in parts])
            for k in parts[0]}


@pytest.fixture(scope='module')
def dp_steps(rank_runs):
    r = rank_runs
    return dict(want=r['want'], masks=r['masks'], jseen=r['jseen'],
                free=[x['free'] for x in r['ranks']],
                forced=[x['forced'] for x in r['ranks']], one=r['grounder'],
                one_seen=r['one_seen'], one_forced=r['forced'], sd=r['sd'])


def _dp_record(dp, step, side):
    """(JAX record, rank 0's) of a step, the second from the JAX
    package's state after the first; or (one-process record, rank 0's),
    free-running, or from that state (side 'one_forced')."""
    if side == 'jax':
        return dp['want'][step], (dp['free'][0]['steps'][0] if step == 0
                                  else dp['forced'][0]['steps'][0])
    if side == 'one_forced':
        return dp['one_forced'], dp['forced'][0]['steps'][0]
    return dp['one'][step], dp['free'][0]['steps'][step]


def _jax_seen(dp, step):
    """The ranks' level-0 voxel keys and assignments side by side: the
    free run's first step, the run from the JAX state for the second."""
    ranks = ([r['seen'] for r in dp['free']] if step == 0
             else [r['seen'] for r in dp['forced']])
    return (cat([r['keys'][0] for r in ranks]),
            cat([r['assign'][0] for r in ranks], 1))


def test_dp_masks_are_global(dp_steps):
    """10 dropout draws a step (5 a proxy block), each a mask of the
    global batch that every rank slices."""
    assert len(dp_steps['masks']) == 10
    assert all(m.shape[0] == 4 for m in dp_steps['masks'].values())
    for r in dp_steps['free']:
        assert r['drawn'] == 2 * 10


def _layers(assign):
    """A step's per-layer assignments in a canonical order: the sharded
    JAX step runs the two layers' callbacks (one each under the head's
    vmap) in no defined order."""
    return sorted((np.asarray(a) for a in assign), key=lambda a: a.tobytes())


@pytest.mark.parametrize('step', [0, 1])
def test_dp_integer_stages_bit_exact(dp_steps, step):
    """The ranks' level-0 voxel keys and Hungarian assignments, side by
    side, equal the sharded JAX step's bit for bit (the second step from
    the JAX package's state after the first)."""
    j = dp_steps['jseen']
    keys, assign = _jax_seen(dp_steps, step)
    np.testing.assert_array_equal(keys, j['keys'][step])
    want = j['assign'][2 * step:2 * step + 2]
    assert len(want) == len(assign) == 2
    for got, w in zip(_layers(assign), _layers(want)):
        np.testing.assert_array_equal(got, w)
    assert (assign >= 0).sum() == 2 * (2 + 3) * 2   # every valid gt matched


@pytest.mark.parametrize('step', [0, 1])
def test_dp_losses_and_norm_match_jax(dp_steps, step):
    """test_torch_port_train.py's bounds of a step: losses to 2e-5
    relative, grad_norm to 1e-4 (the second step from the JAX package's
    state after the first), on both ranks."""
    want = dp_steps['want'][step]['metrics']
    runs = dp_steps['free'] if step == 0 else dp_steps['forced']
    for r in runs:
        got = r['steps'][0]['metrics']
        assert set(got) == set(want)
        for k, v in want.items():
            rtol = 1e-4 if k == 'grad_norm' else 2e-5
            np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


@pytest.mark.parametrize('step', [0, 1])
def test_dp_every_gradient_matches_jax(dp_steps, step):
    """Every gradient (rank 0's rank mean) within test_torch_port_train.
    py's `_grad_tol` of the JAX package's sharded step."""
    want, got = _dp_record(dp_steps, step, 'jax')
    gn = want['metrics']['grad_norm']
    bad = [(k, float(np.abs(g - want['grads'][k]).max()))
           for k, g in got['grads'].items()
           if np.abs(g - want['grads'][k]).max()
           > _grad_tol(want['grads'][k], gn)]
    assert not bad, f'{bad[:5]} ({len(bad)} of {len(got["grads"])})'


@pytest.mark.parametrize('step', [0, 1])
def test_dp_updated_state_matches_jax(dp_steps, step):
    """Parameters and running statistics after the update within
    test_torch_port_train.py's bound (1e-6 + 1e-5 of the tensor's max,
    plus what the gradient's tolerance allows Adam's update)."""
    want, got = _dp_record(dp_steps, step, 'jax')
    gn = want['metrics']['grad_norm']
    lr = 5e-4
    bad = []
    for k, g in got['state'].items():
        w = want['state'][k]
        tol = 1e-6 + 1e-5 * np.abs(w).max()
        if k in want['grads']:
            gk = np.abs(want['grads'][k])
            tol = tol + 2.2 * lr * np.minimum(
                1.0, _grad_tol(gk, gn) / np.maximum(gk, 1e-30))
        if np.any(np.abs(g - w) > tol):
            bad.append((k, float(np.abs(g - w).max())))
    assert not bad, bad[:5]


def tight_step_check(want, got, lr=5e-4, state=True):
    """One step against the port's own one-process step (the same float32
    code, the sums split over two ranks): losses and grad_norm to 1e-6
    relative; every gradient within 1e-5 of its tensor's max plus 1e-7 of
    the gradient norm (`tight_grad_tol`); with `state`, the updated state
    within 1e-6 + 1e-6 of its max plus Adam's allowance for that gradient
    tolerance (test_torch_port_train.py's 2.2 lr · min(1, tol / |g|): an
    entry whose gradient is at rounding level moves by ±lr either way)."""
    assert set(got['metrics']) == set(want['metrics'])
    for k, v in want['metrics'].items():
        np.testing.assert_allclose(got['metrics'][k], v, rtol=1e-6,
                                   err_msg=k)
    gn = want['metrics']['grad_norm']
    assert set(got['grads']) <= set(want['grads'])
    bad = [k for k, g in got['grads'].items()
           if np.abs(g - want['grads'][k]).max()
           > tight_grad_tol(want['grads'][k], gn)]
    assert not bad, bad[:5]
    if not state:
        return
    bad = []
    for k, g in got['state'].items():
        w = want['state'][k]
        tol = 1e-6 + 1e-6 * np.abs(w).max()
        if k in want['grads']:
            gk = np.abs(want['grads'][k])
            tol = tol + 2.2 * lr * np.minimum(
                1.0, tight_grad_tol(gk, gn) / np.maximum(gk, 1e-30))
        if np.any(np.abs(g - w) > tol):
            bad.append((k, float(np.abs(g - w).max())))
    assert not bad, bad[:5]


def tight_grad_tol(want, grad_norm):
    return 1e-5 * float(np.abs(want).max()) + 1e-7 * grad_norm


@pytest.mark.parametrize('side', ['free_0', 'free_1', 'one_forced'])
def test_dp_step_matches_the_one_process_step(dp_steps, side):
    """Both free-running steps, and the second from the JAX package's
    state after the first, against the port's one process on the global
    batch (`tight_step_check`; the free second step's state carries the
    first step's ±lr moves, so its state is checked from the shared
    state only)."""
    if side == 'one_forced':
        want, got = _dp_record(dp_steps, 1, side)
    else:
        want, got = _dp_record(dp_steps, int(side[-1]), 'one')
    tight_step_check(want, got, state=side != 'free_1')


def test_dp_free_second_step_integer_stages_equal_one_process(dp_steps):
    """The free-running second step's voxel keys and assignments equal the
    one-process port's bit for bit."""
    ranks = [r['seen'] for r in dp_steps['free']]
    np.testing.assert_array_equal(cat([r['keys'][1] for r in ranks]),
                                  dp_steps['one_seen']['keys'][1])
    np.testing.assert_array_equal(cat([r['assign'][1] for r in ranks], 1),
                                  dp_steps['one_seen']['assign'][1])


def test_dp_ranks_hold_the_same_state(dp_steps):
    """After every step both ranks hold the same parameters, running
    statistics and metrics, bit for bit; the frozen text tower is as it
    was."""
    for run in ('free', 'forced'):
        r0, r1 = dp_steps[run]
        for a, b in zip(r0['steps'], r1['steps']):
            assert a['metrics'] == b['metrics']
            for k, v in a['state'].items():
                assert np.array_equal(v, b['state'][k]), (run, k)
    final = dp_steps['free'][0]['steps'][-1]['state']
    frozen = [k for k in dp_steps['sd'] if k.startswith('text_encoder.')]
    assert frozen
    for k in frozen:
        assert np.array_equal(final[k], np.asarray(dp_steps['sd'][k])), k


# --------------------------------------------------------------------------
# the tiny detector
# --------------------------------------------------------------------------
@pytest.fixture(scope='module')
def det_steps(rank_runs):
    return dict(one=rank_runs['det_one'],
                two=[r['detector'] for r in rank_runs['ranks']])


@pytest.mark.parametrize('step', [0, 1])
def test_dp_detector_step_matches_one_process(det_steps, step):
    """Global B=4 on 2 ranks against one process (`tight_step_check`;
    every gradient tensor present on both sides), the second step from
    the one-process model and AdamW state after the first."""
    want, got = det_steps['one'][step], det_steps['two'][0][step]
    assert set(got['grads']) == set(want['grads'])
    tight_step_check(want, got)


def test_dp_detector_ranks_hold_the_same_state(det_steps):
    r0, r1 = det_steps['two']
    for a, b in zip(r0, r1):
        assert a['metrics'] == b['metrics']
        for k, v in a['state'].items():
            assert np.array_equal(v, b['state'][k]), k
