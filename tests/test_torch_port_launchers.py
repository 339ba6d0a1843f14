"""`--launcher slurm` and `--launcher mpi` (`parallel/dist.py::
slurm_context` / `mpi_context`) against the cluster detection of
`jax.distributed.initialize()` (`jax._src.clusters.SlurmCluster` and
`OmpiCluster`) under the same faked environments: rank, world, local
rank and coordinator; a missing variable raises and names itself, a job
with unequal nodes raises. The two-rank training run through `--launcher
slurm` is in tests/test_torch_port_parallel_runner.py.
"""
import pytest
from jax._src.clusters import OmpiCluster, SlurmCluster

from proxytransformation_torch.parallel import dist as pdist
from proxytransformation_torch.parallel.launch import launcher_context

SLURM_JOB = dict(SLURM_JOB_ID='4182391', SLURM_STEP_NUM_NODES='3',
                 SLURM_NTASKS='6')
OMPI_URIS = ('1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911',
             '2654994432.0;tcp://node-a.cluster:40001',
             '1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d:c083:'
             '150e::3000:2]:43370')
NODE_LISTS = ('node001', 'node001,host2', 'node[001-015],host2',
              'node[003-005,9]', 'node[001,007-015]', 'gpu-a[12,14]',
              'dgx[0100-0103],dgx[0200-0201]')


@pytest.fixture
def clean_env(monkeypatch):
    for k in (*pdist._SLURM_KEYS, *pdist._OMPI_KEYS, 'MASTER_PORT',
              'JAX_COORDINATOR_PORT'):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _slurm(mp, node_list, rank, **extra):
    env = dict(SLURM_JOB, SLURM_STEP_NODELIST=node_list,
               SLURM_PROCID=str(rank), SLURM_LOCALID=str(rank % 2),
               SLURM_NODEID=str(rank // 2), **extra)
    for k, v in env.items():
        mp.setenv(k, v)


@pytest.mark.parametrize('node_list', NODE_LISTS)
@pytest.mark.parametrize('rank', [0, 3, 5])
def test_slurm_context_is_jax_detection(clean_env, node_list, rank):
    """6 tasks on 3 nodes, 2 a node: the port's rank, world, local rank and
    coordinator (host and the job's port) are JAX's."""
    _slurm(clean_env, node_list, rank)
    assert SlurmCluster.is_env_present()
    ctx, coordinator = pdist.slurm_context()
    assert (ctx.rank, ctx.world, ctx.local_rank) == (
        SlurmCluster.get_process_id(), SlurmCluster.get_process_count(),
        SlurmCluster.get_local_process_id())
    assert (ctx.local_world, ctx.node, ctx.nodes) == (2, rank // 2, 3)
    assert coordinator == SlurmCluster.get_coordinator_address(None, None)
    assert coordinator.endswith(f':{4182391 % 4096 + 61440}')


def test_slurm_master_port_and_the_rendezvous(clean_env):
    """MASTER_PORT names the port (JAX's own override is
    JAX_COORDINATOR_PORT); the rendezvous is tcp:// at the coordinator
    unless the config names another."""
    _slurm(clean_env, 'node[003-005,9]', 1, MASTER_PORT='29511')
    ctx, coordinator = pdist.slurm_context()
    assert coordinator == 'node003:29511' == (
        SlurmCluster.get_coordinator_address(None, '29511'))
    assert launcher_context('slurm', {}) == (ctx, 'tcp://node003:29511')
    cfg = {'env_cfg': {'dist_cfg': {'init_method': 'file:///tmp/rdv'}}}
    assert launcher_context('slurm', cfg) == (ctx, 'file:///tmp/rdv')


def test_slurm_one_host_range_drops_its_bracket(clean_env):
    """'node[7]': JAX's parser keeps the closing bracket ('node7]:port'),
    the port gives the host."""
    _slurm(clean_env, 'node[7]', 0)
    assert SlurmCluster.get_coordinator_address(None, '1').startswith(
        'node7]')
    assert pdist.slurm_context()[1].startswith('node7:')


@pytest.mark.parametrize('missing', pdist._SLURM_KEYS)
def test_slurm_missing_variable_raises_naming_it(clean_env, missing):
    _slurm(clean_env, 'node001', 0)
    clean_env.delenv(missing)
    with pytest.raises(RuntimeError, match=f'--launcher slurm: .*{missing}'):
        pdist.slurm_context()


@pytest.mark.parametrize('env', [
    dict(SLURM_NTASKS='5'),                        # 5 tasks on 3 nodes
    dict(SLURM_PROCID='2', SLURM_NODEID='0'),      # rank 2 on node 0 of 2
    dict(SLURM_LOCALID='1', SLURM_PROCID='0')])    # cyclic distribution
def test_slurm_unequal_or_cyclic_job_raises(clean_env, env):
    _slurm(clean_env, 'node001', 0)
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match='same number of ranks'):
        pdist.slurm_context()


def _ompi(mp, uri, rank, world=4, local=2, **extra):
    env = dict(OMPI_MCA_orte_hnp_uri=uri, OMPI_COMM_WORLD_SIZE=str(world),
               OMPI_COMM_WORLD_RANK=str(rank),
               OMPI_COMM_WORLD_LOCAL_RANK=str(rank % local),
               OMPI_COMM_WORLD_LOCAL_SIZE=str(local), **extra)
    for k, v in env.items():
        mp.setenv(k, v)


@pytest.mark.parametrize('uri', OMPI_URIS)
@pytest.mark.parametrize('rank', [0, 3])
def test_mpi_context_is_jax_detection(clean_env, uri, rank):
    """4 processes on 2 nodes: rank, world, local rank and coordinator
    are JAX's (an IPv6 launcher address in brackets)."""
    _ompi(clean_env, uri, rank)
    assert OmpiCluster.is_env_present()
    ctx, coordinator = pdist.mpi_context()
    assert (ctx.rank, ctx.world, ctx.local_rank) == (
        OmpiCluster.get_process_id(), OmpiCluster.get_process_count(),
        OmpiCluster.get_local_process_id())
    assert (ctx.local_world, ctx.node) == (2, rank // 2)
    want = OmpiCluster.get_coordinator_address(None, None)
    host, port = want.rsplit(':', 1)
    if ':' in host:
        host = f'[{host}]'
    assert coordinator == f'{host}:{port}'
    clean_env.setenv('MASTER_PORT', '29400')
    assert pdist.mpi_context()[1] == f'{host}:29400'


@pytest.mark.parametrize('missing', pdist._OMPI_KEYS)
def test_mpi_missing_variable_raises_naming_it(clean_env, missing):
    _ompi(clean_env, OMPI_URIS[0], 0)
    clean_env.delenv(missing)
    with pytest.raises(RuntimeError, match=f'--launcher mpi: .*{missing}'):
        pdist.mpi_context()


def test_mpi_unequal_nodes_raise(clean_env):
    _ompi(clean_env, OMPI_URIS[0], 0, world=5, local=2)
    with pytest.raises(RuntimeError, match='same number of ranks'):
        pdist.mpi_context()
