"""The port's training and rendering over several ranks, on the CPU.

``anerf_torch/parallel/sharding.py`` against ``anerf_tpu``'s: the
helpers in this process; then two gloo ranks, spawned by
``_torch_parallel_worker.spawn`` (torch and anerf_torch only, a
``file://`` store, a time limit each), against anerf_tpu's
one-process step on the global batch: in both batch modes
(``shard_batch`` and ``global_batch=True``), for two subjects (the
K5/K6 twins), and FlipFlop's trackers against the one-rank port's;
bundles of steps (``shard_train_step(..., stacked=True)``) against as
many eager sharded steps, bit for bit, and against anerf_tpu's sharded
bundle.  The per-rank pixel draw (``host_slice``) bit-equal to anerf_tpu's for both
ranks of two; the sharded renderer against one rank.

Bars.  anerf_tpu's own for a sharded step against one process
(``test_trainer.py``: losses 2e-5 relative, parameters and bones within
2e-6), held on every parameter, the pose bank and its accumulator, plus
the Adam moments' direction (cosine > 1 - 1e-6) and counts.  Not
``test_torch_train.py``'s (``_compare_states``): at this tiny config the
one-rank port already misses its moment-norm bar of 1e-4 on a
one-element leaf whose gradient sits at f32 noise (5.6e-3; two ranks
5.5e-3; ROADMAP C.14, a property: ``C14_LEAF``), and the rank split moves the f32 summation order again
(parameters within 1.7e-6 of anerf_tpu over two ranks, 1.4e-6 over
one).  The two-subject step runs the K5/K6 twins' bf16 chain, which
sits 1e-3 from anerf_tpu's f32 XLA path at this width: its two ranks
are held against the one-rank port's step on the global batch, the
moments' direction at ``test_torch_train_fused.py``'s bf16 bar (5e-4)
and the NeRF update as ``_sharded_bars`` says, its loss against
anerf_tpu's at ``test_torch_multisubject.py``'s fused bar (1e-4).  The render at ``test_sharded_eval.py``'s (rgb 1e-5,
disparity 1e-4).
"""
import dataclasses
import os

import h5py
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anerf_tpu.data import dataset as JD
from anerf_tpu.data import loaders as JL
from anerf_tpu.data import native
from anerf_tpu.data import pipeline as JPL
from anerf_tpu.data.h5_writer import make_synthetic_h5
from anerf_tpu.models.factory import build_raycast_config as j_build
from anerf_tpu.parallel.sharding import pad_rays_to_shards as j_pad
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL
from anerf_tpu.training import pose_opt as JP
from anerf_tpu.training import trainer as JT

from anerf_torch import testing_utils as T
from anerf_torch.data import dataset as TD
from anerf_torch.data import loaders as TL
from anerf_torch.data import pipeline as TPL
from anerf_torch.data.store import h5_to_store
from anerf_torch.interop import train_state_from_jax
from anerf_torch.models.factory import build_raycast_config as t_build
from anerf_torch.models.factory import embed_state, init_raycaster_params
from anerf_torch.ops.fk import get_smpl_l2ws_np
from anerf_torch.ops.cylinder import get_kp_bounding_cylinder
from anerf_torch.parallel import sharding as S
from anerf_torch.render.renderer import ImageRenderer
from anerf_torch.skeleton import SMPL_REST_POSE
from anerf_torch.training import trainer as TT
from anerf_torch.utils.config import Config as TConfig

import _torch_parallel_worker as W
from test_torch_train import LR, _cos, _flat, _jax_numpy_state, \
    train_state_to_numpy
from test_trainer import make_setup_and_batch, tiny_config
from test_torch_threads import one_torch_thread  # noqa: F401

TRAIN = dict(opt_pose=True, opt_pose_step=1, opt_pose_coef=0.1, perturb=0.,
             raw_noise_std=0.)
STEPS = 2


def _port_kwargs(jcfg):
    """The port Config's fields of an anerf_tpu Config."""
    names = {f.name for f in dataclasses.fields(TConfig)}
    return {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
            if f.name in names}


def _numpy_batch(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _jax_run(step, state, batch, n):
    out = []
    for i in range(n):
        state, stats = step(state, batch, jax.random.PRNGKey(i))
        out.append((state, stats))
    return out


def _losses_close(j_stats, t_stats, rtol):
    """``test_torch_train._run``'s losses, and the reduced statistics:
    psnr from the global MSE, alpha, and mpjpc (mm) within the pose
    bank's bar of 1e-6 over ext_scale 1e-3 (after a step it measures
    moves of f32 noise size)."""
    for k in ('total_loss', 'rgb_loss', 'rgb_loss0', 'kp_loss', 'psnr',
              'psnr0', 'alpha'):
        a, b = float(j_stats[k]), float(t_stats[k])
        assert abs(a - b) <= rtol * abs(a) + 1e-9, (k, a, b)
    assert abs(float(j_stats['mpjpc']) - float(t_stats['mpjpc'])) <= 1e-3


def _sharded_bars(ref, got, start=None, atol=2e-6, mom_cos=1e-6,
                  noise_leaves=()):
    """anerf_tpu's sharded-step bars on every leaf (see the module
    docstring); ``ref`` and ``got`` as ``train_state_to_numpy`` gives
    them (``_jax_numpy_state`` for anerf_tpu's).  Given the ``start``
    of one step on a bf16 chain, the NeRF parameters are held by their
    update instead: each rank's bf16 dW rounds on its own, and Adam's
    first step moves a parameter whose gradient is that small by up to
    2 lr, so the whole update's direction (cosine > 1 - 1e-3, a tenth of
    ``test_torch_multisubject.py``'s fused bar; measured 1 - 1.3e-4) and
    each leaf's gradient (the first moment) at the card's backward bars
    (cosine > 1 - 1e-4, norm within 5e-3).  ``noise_leaves`` names
    parameter leaves (by their index in ``_flat``'s order) whose gradient
    sits at f32 noise (ROADMAP C.14): each is held within 2 lr, the bar
    ``test_torch_train._compare_states`` holds its outliers to."""
    assert ref['step'] == got['step']
    for k in ('opt_state', 'pose_opt_state'):
        assert ref[k]['count'] == got[k]['count'], k
        for m in ('mu', 'nu'):
            for a, b in zip(_flat(ref[k][m]), _flat(got[k][m])):
                assert _cos(a, b) > 1 - mom_cos, (k, m, _cos(a, b))
    if start is not None:
        for a, b in zip(_flat(ref['opt_state']['mu']),
                        _flat(got['opt_state']['mu'])):
            assert _cos(a, b) > 1 - 1e-4
            if np.linalg.norm(a) > 1e-20:
                assert abs(np.linalg.norm(b) / np.linalg.norm(a) - 1) < 5e-3
        upd = [np.concatenate([x - x0 for x0, x in zip(
            _flat(start['params']), _flat(s['params']))]) for s in (ref, got)]
        assert _cos(*upd) > 1 - 1e-3, _cos(*upd)
    for k in ('pose_params', 'pose_accum') + (
            ('params',) if start is None else ()):
        for i, (a, b) in enumerate(zip(_flat(ref[k]), _flat(got[k]))):
            noise = k == 'params' and i in noise_leaves
            np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR if noise
                                       else atol, err_msg=f'{k} {i}')


def _ranks_agree(results):
    """Both ranks' states bit-equal after every step."""
    for (s0, _), (s1, _) in zip(results[0]['steps'], results[1]['steps']):
        W.same_bits(s0, s1)


@pytest.fixture(scope='module')
def one_subject():
    """anerf_tpu's one-process step on the 16-ray global batch of
    ``test_trainer.make_setup_and_batch``, and the same start for the
    port's ranks."""
    jcfg = tiny_config(**TRAIN)
    setup, batch, (kps, bones) = make_setup_and_batch(jcfg)
    j_state = JT.init_train_state(setup, jax.random.PRNGKey(0),
                                  init_kp3d=kps, init_bones=bones)
    t_state = W.to_numpy(train_state_from_jax(j_state))
    spec = dict(cfg=_port_kwargs(jcfg), n_frames=3,
                rest=SMPL_REST_POSE * 0.0022, kps=np.asarray(kps),
                bones=np.asarray(bones), near=0.1, far=6.0)
    ref = _jax_run(jax.jit(JT.make_train_step(setup)), j_state, batch, STEPS)
    return dict(spec=spec, state=t_state, batch=_numpy_batch(batch), ref=ref)


# ---- the helpers, in this process -----------------------------------------

def test_pad_rays_to_shards_matches_jax():
    for n in (0, 1, 7, 64, 1000):
        for shards in (1, 2, 3, 8):
            for mult in (1, 4, 128):
                assert S.pad_rays_to_shards(n, shards, mult) == \
                    j_pad(n, shards, mult)


def test_init_distributed_without_environment_is_noop(monkeypatch):
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    assert S.init_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()
    assert S.make_mesh() == S.RayMesh(0, 1, None)
    assert S.make_mesh(1).size == 1
    with pytest.raises(ValueError, match='torchrun'):
        S.make_mesh(2)


def test_shard_batch_takes_the_rank_block():
    batch = {'rays_o': np.arange(24).reshape(8, 3),
             'kp_idx': torch.arange(8), 'bgs': None}
    for rank in range(4):
        got = S.shard_batch(S.RayMesh(rank, 4), batch)
        assert np.array_equal(got['rays_o'],
                              batch['rays_o'][2 * rank:2 * rank + 2])
        assert torch.equal(got['kp_idx'], torch.arange(2 * rank,
                                                       2 * rank + 2))
        assert got['bgs'] is None
    with pytest.raises(ValueError, match='multiple of 3'):
        S.shard_batch(S.RayMesh(0, 3), batch)


def test_rank_generators_and_bundles_over_ranks(one_subject, monkeypatch):
    """Rank 0 draws as one process does and the other ranks apart;
    steps bundled into one call are built over the ranks of one host
    and refused past it (torchrun's LOCAL_WORLD_SIZE below the world
    size), as anerf_tpu bundles on one host only."""
    firsts = [torch.rand(4, generator=S.rank_generator(S.RayMesh(r, 3), 7,
                                                       'cpu'))
              for r in range(3)]
    assert torch.equal(firsts[0], torch.rand(
        4, generator=torch.Generator().manual_seed(7)))
    assert not torch.equal(firsts[0], firsts[1])
    assert not torch.equal(firsts[1], firsts[2])
    setup = W._setup(one_subject['spec'], mesh=S.RayMesh(0, 2))
    monkeypatch.delenv('LOCAL_WORLD_SIZE', raising=False)
    assert callable(TT.make_multi_train_step(setup, 2))
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '2')
    assert callable(S.shard_train_step(setup, S.RayMesh(0, 2), stacked=True,
                                       steps=2))
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '1')
    with pytest.raises(NotImplementedError, match='one host'):
        TT.make_multi_train_step(setup, 2)
    with pytest.raises(NotImplementedError, match='one host'):
        S.shard_train_step(setup, S.RayMesh(1, 2), stacked=True, steps=2)
    # one step a call, or one rank, needs no host rule
    TT.make_train_step(setup)
    TT.make_multi_train_step(W._setup(one_subject['spec'],
                                      mesh=S.RayMesh(0, 1)), 2)


def test_shard_batch_stacked_takes_the_rank_block_of_every_step():
    """A bundle's batches: the step on the leading axis, the rays on the
    second, each rank's block of every step (anerf_tpu's
    ``P(None, 'data')``)."""
    batch = {'rays_o': np.arange(72).reshape(3, 8, 3),
             'kp_idx': torch.arange(24).reshape(3, 8), 'bgs': None}
    for rank in range(4):
        got = S.shard_batch(S.RayMesh(rank, 4), batch, stacked=True)
        block = slice(2 * rank, 2 * rank + 2)
        assert np.array_equal(got['rays_o'], batch['rays_o'][:, block])
        assert torch.equal(got['kp_idx'], batch['kp_idx'][:, block])
        assert got['bgs'] is None
    with pytest.raises(ValueError, match='multiple of 3'):
        S.shard_batch(S.RayMesh(0, 3), batch, stacked=True)


def test_world_of_one_is_bit_equal_to_the_plain_step(one_subject, tmp_path):
    """A gloo world of one through ``shard_train_step`` (collectives
    and all) against ``make_train_step``: the same bits, stats too."""
    plain = TT.make_train_step(W._setup(one_subject['spec']))
    a = W.to_torch(one_subject['state'])
    b = W.to_torch(one_subject['state'])
    batch = W.to_torch(one_subject['batch'])
    S.init_distributed(backend='gloo',
                       init_method=f'file://{tmp_path / "store"}', rank=0,
                       world_size=1)
    try:
        mesh = S.make_mesh(1)
        assert mesh.group is not None
        sharded = S.shard_train_step(W._setup(one_subject['spec']), mesh)
        for _ in range(STEPS):
            a, sa = plain(a, batch, None)
            b, sb = sharded(b, batch, None)
            W.same_bits(W.to_numpy(a), W.to_numpy(b))
            W.same_bits(W.to_numpy(sa), W.to_numpy(sb))
    finally:
        torch.distributed.destroy_process_group()


# ---- two ranks against anerf_tpu's one-process step -----------------------

BUNDLE_STEPS = 3


@pytest.fixture(scope='module')
def jax_bundle(one_subject):
    """anerf_tpu's bundle of BUNDLE_STEPS steps over a mesh of two CPU
    devices (``shard_train_step(make_multi_train_step(setup, k), mesh,
    stacked=True)``, as its run_train.py builds it) on the global batch
    stacked k times."""
    from anerf_tpu.parallel import sharding as JS
    jcfg = tiny_config(**TRAIN)
    setup, batch, (kps, bones) = make_setup_and_batch(jcfg)
    mesh = JS.make_mesh(2)
    state = JS.replicate_state(mesh, JT.init_train_state(
        setup, jax.random.PRNGKey(0), init_kp3d=kps, init_bones=bones))
    step = JS.shard_train_step(JT.make_multi_train_step(setup, BUNDLE_STEPS),
                               mesh, stacked=True)
    return step(state, JT.stack_batches([_numpy_batch(batch)] * BUNDLE_STEPS),
                jax.random.PRNGKey(0))


@pytest.mark.parametrize('global_batch', [False, True],
                         ids=['shard_batch', 'global_batch'])
def test_two_rank_bundles_match_eager_steps_and_jax(jax_bundle, global_batch,
                                                    ranks):
    """A bundle of BUNDLE_STEPS steps over two gloo ranks (the steps'
    body in turn: gloo cannot be captured) is bit-equal on each rank to
    as many eager sharded steps, the ranks agree bit for bit, and the
    result holds to anerf_tpu's sharded bundle at
    ``test_two_ranks_match_jax_global_step``'s bars."""
    results = ranks[f'bundle_{"global_batch" if global_batch else "shard_batch"}']
    for r in results:
        W.same_bits(r['eager'], r['bundle'])
    W.same_bits(results[0]['bundle'], results[1]['bundle'])
    ts, t_stats = results[0]['bundle']
    assert ts['step'] == BUNDLE_STEPS
    js, j_stats = jax_bundle
    _losses_close(j_stats, t_stats, 2e-5)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(js['params'])]
    _sharded_bars(_jax_numpy_state(js), train_state_to_numpy(W.to_torch(ts)),
                  noise_leaves=(names.index(C14_LEAF),))


# ROADMAP C.14: the one-element leaf whose gradient is the sum of terms
# that cancel to 2.5e-3 of their magnitudes, so that any two f32 orders
# of the sum read it 1e-2 apart (the port's f32 gradient is 1.2e-2 from
# an f64 evaluation, anerf_tpu's 8.7e-3); after three Adam steps it sits
# 3.0e-6 from anerf_tpu's two-device bundle, and anerf_tpu's own
# two-device bundle 1.2e-6 from its one-process steps
C14_LEAF = "['fine']['alpha_linear']['b']"

@pytest.mark.parametrize('global_batch', [False, True],
                         ids=['shard_batch', 'global_batch'])
def test_two_ranks_match_jax_global_step(one_subject, global_batch, ranks):
    results = ranks['global_batch' if global_batch else 'shard_batch']
    _ranks_agree(results)
    for (js, j_stats), (ts, t_stats) in zip(one_subject['ref'],
                                            results[0]['steps']):
        _losses_close(j_stats, t_stats, 2e-5)
        _sharded_bars(_jax_numpy_state(js),
                      train_state_to_numpy(W.to_torch(ts)))
    assert ts['pose_opt_state']['count'] == STEPS


@pytest.fixture(scope='module')
def two_subjects():
    """A two-subject scene on the fused backend (its split route, the
    K5/K6 twins) and anerf_tpu's XLA setup of it."""
    n_frames, n_rays = 4, 16
    rest, bones, _, kps, skts, cyls = T.synthetic_pose(n_frames,
                                                       n_subjects=2)
    subj = T.subject_of_frame(n_frames, 2)
    batch = T.synthetic_batch(n_rays, n_frames, kps, skts, bones, cyls)
    batch['subject_idxs'] = subj[batch['kp_idx']]
    jcfg = tiny_config(mlp_backend='xla', **TRAIN)
    j_setup = JT.TrainSetup(
        cfg=jcfg, rc=j_build(jcfg, n_framecodes=n_frames, n_subjects=2),
        skel=JSMPL, rest_pose=jnp.asarray(rest),
        anchors=JP.make_anchors(kps, bones),
        rest_pose_idxs=jnp.asarray(subj), near=0.0, far=1.0)
    j_state = JT.init_train_state(j_setup, jax.random.PRNGKey(0),
                                  init_kp3d=kps, init_bones=bones)
    spec = dict(cfg=dict(_port_kwargs(jcfg), mlp_backend='pallas'),
                n_frames=n_frames, n_subjects=2, rest=rest, kps=kps,
                bones=bones, subj=subj, near=0.0, far=1.0)
    return dict(spec=spec, start=W.to_numpy(train_state_from_jax(j_state)),
                batch=batch, j_setup=j_setup, j_state=j_state)


@pytest.fixture(scope='module')
def flipflop(one_subject):
    """The one-subject scene in the alternating mode (pose turns every
    step, reset snapshots), and its fresh port state."""
    spec = dict(one_subject['spec'], cfg=dict(
        one_subject['spec']['cfg'], opt_pose_flipflop=True,
        opt_pose_interval=1, opt_pose_reset=True))
    state = TT.init_train_state(W._setup(spec),
                                torch.Generator().manual_seed(0),
                                init_kp3d=spec['kps'],
                                init_bones=spec['bones'])
    return dict(spec=spec, start=W.to_numpy(state))


@pytest.fixture(scope='module')
def ranks(one_subject, two_subjects, flipflop, scene, tmp_path_factory):
    """Two gloo ranks, spawned once, run every two-rank case of this
    file; each case's results by rank."""
    train = lambda spec, state, steps, global_batch=False, batch=None: (
        'train', dict(spec=spec, state=state, steps=steps,
                      global_batch=global_batch,
                      batch=one_subject['batch'] if batch is None
                      else batch))
    jobs = {
        'shard_batch': train(one_subject['spec'], one_subject['state'],
                             STEPS),
        'global_batch': train(one_subject['spec'], one_subject['state'],
                              STEPS, global_batch=True),
        **{f'bundle_{k}': ('bundle', dict(
            spec=one_subject['spec'], state=one_subject['state'],
            batch=one_subject['batch'], steps=BUNDLE_STEPS,
            global_batch=k == 'global_batch'))
           for k in ('shard_batch', 'global_batch')},
        'two_subjects': train(two_subjects['spec'], two_subjects['start'],
                              1, batch=two_subjects['batch']),
        'flipflop': train(flipflop['spec'], flipflop['start'], STEPS),
        'regularizer': train(*_regularizer(one_subject), 1,
                             batch=_regularizer_batch(one_subject)),
        'render': ('render', dict(
            spec=scene['spec'], params=W.to_numpy(scene['params']),
            est=scene['est'], chunks=(64, 60), image=scene['image']))}
    results = W.spawn('jobs', dict(jobs=jobs),
                      tmp_path_factory.mktemp('ranks'))
    assert not any(r['jax_imported'] for r in results)
    return {name: [r['jobs'][name] for r in results] for name in jobs}


def _regularizer(one_subject):
    """The one-subject scene with the masked L1 regularizer on."""
    return (dict(one_subject['spec'], cfg=dict(
        one_subject['spec']['cfg'], reg_fn='L1', reg_coef=0.5)),
        one_subject['state'])


def _regularizer_batch(one_subject):
    """The batch with 2 rays off the foreground in rank 0's block and 5
    in rank 1's: the ranks' masked means have other counts."""
    batch = dict(one_subject['batch'])
    fgs = batch['fgs'].copy()
    fgs[[1, 6, 8, 9, 11, 13, 14]] = 0.
    batch['fgs'] = fgs
    return batch


def test_two_ranks_masked_regularizer_matches_one_rank(one_subject, ranks):
    """The regularizer's mean over the pixels off the foreground is the
    global batch's although the ranks hold other counts of them
    (``trainer._masked_share``): the one-rank port's step at the bars
    of the module docstring."""
    spec, state = _regularizer(one_subject)
    one, one_stats = TT.make_train_step(W._setup(spec))(
        W.to_torch(state), W.to_torch(_regularizer_batch(one_subject)),
        None)
    results = ranks['regularizer']
    _ranks_agree(results)
    ((ts, t_stats),) = results[0]['steps']
    assert float(one_stats['reg_loss']) > 1e-3
    for k in ('total_loss', 'reg_loss', 'reg_loss0', 'rgb_loss'):
        a, b = float(one_stats[k]), float(t_stats[k])
        assert abs(a - b) <= 2e-5 * abs(a), (k, a, b)
    _sharded_bars(train_state_to_numpy(one),
                  train_state_to_numpy(W.to_torch(ts)))


def test_two_ranks_two_subjects_match_one_rank(two_subjects, ranks):
    """One two-subject step on the K5/K6 twins (the fused backend's
    split route) over two ranks against the one-rank port's step on the
    global batch, its loss against anerf_tpu's XLA step."""
    spec, start, batch = (two_subjects[k] for k in ('spec', 'start',
                                                     'batch'))
    setup = W._setup(spec)
    assert setup.rc.mlp_backend == 'fused'
    results = ranks['two_subjects']
    _ranks_agree(results)
    one, one_stats = TT.make_train_step(setup)(
        W.to_torch(start), W.to_torch(batch), None)
    ((ts, t_stats),) = results[0]['steps']
    _losses_close(one_stats, t_stats, 2e-5)
    _sharded_bars(train_state_to_numpy(one),
                  train_state_to_numpy(W.to_torch(ts)),
                  start=train_state_to_numpy(W.to_torch(start)),
                  mom_cos=5e-4)
    ((_, j_stats),) = _jax_run(
        jax.jit(JT.make_train_step(two_subjects['j_setup'])),
        two_subjects['j_state'], {k: jnp.asarray(v)
                                  for k, v in batch.items()}, 1)
    for k in ('total_loss', 'rgb_loss', 'rgb_loss0'):
        a, b = float(j_stats[k]), float(t_stats[k])
        assert abs(a - b) <= 1e-4 * abs(a), (k, a, b)


def test_two_ranks_flipflop_trackers_match_one_rank(one_subject, flipflop,
                                                    ranks):
    """Two alternating-mode steps: the kp-loss trackers take the global
    batch's per-frame sums and counts, as the one-rank port's do."""
    state = W.to_torch(flipflop['start'])
    batch = W.to_torch(one_subject['batch'])
    step = TT.make_train_step(W._setup(flipflop['spec']))
    ref = []
    for _ in range(STEPS):
        state, stats = step(state, batch, None)
        ref.append((W.to_numpy(state), W.to_numpy(stats)))
    results = ranks['flipflop']
    _ranks_agree(results)
    for (s1, st1), (s2, st2) in zip(ref, results[0]['steps']):
        for k in ('kp_loss_tracker', 'kp_loss_cnt'):
            np.testing.assert_allclose(s2['kp_tracker'][k],
                                       s1['kp_tracker'][k], rtol=1e-6,
                                       atol=0)
        assert abs(st2['kp_tracker_mean'] - st1['kp_tracker_mean']) <= \
            1e-6 * abs(st1['kp_tracker_mean'])
    assert (s2['kp_tracker']['kp_loss_cnt'] > 0).any()


# ---- the per-rank pixel draw ------------------------------------------------

H = W_ = 24


@pytest.fixture(autouse=True)
def numpy_loader(monkeypatch):
    """anerf_tpu's loader on its numpy fallbacks (ANERF_NO_NATIVE=1)."""
    monkeypatch.setenv('ANERF_NO_NATIVE', '1')
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_tried', False)


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    """HDF5 files and their stores: six frames, a second subject, a
    copy whose sampling masks keep 12 pixels (fewer than the global draw
    of 2 x 8, so the ranks take their own streams), and one whose masks
    keep 40 (the rest of the box is NMS's to draw from)."""
    tmp = tmp_path_factory.mktemp('torch_parallel_data')
    out = {}
    for name, kw in (('a', dict(n_frames=6)),
                     ('b', dict(n_frames=5, body_scale=2.0, seed=3)),
                     ('few', dict(n_frames=6)), ('nms', dict(n_frames=6))):
        h5 = make_synthetic_h5(str(tmp / f'{name}.h5'), H=H, W=W_, **kw)
        if name in ('few', 'nms'):
            with h5py.File(h5, 'r+') as f:
                sm = np.zeros_like(f['sampling_masks'][:])
                sm[:, 100:112 if name == 'few' else 140] = 1
                f['sampling_masks'][...] = sm
        out[name] = (h5, h5_to_store(h5, str(tmp / f'{name}.npstore')))
    return out


def _datasets(stores, kind, N=8, **kw):
    if kind == 'concat':
        (ha, sa), (hb, sb) = stores['a'], stores['b']
        return (JD.ConcatH5Dataset([JL.SyntheticDataset(ha, N_samples=N),
                                    JL.SyntheticDataset(hb, N_samples=N)]),
                TD.ConcatDataset([TL.SyntheticDataset(sa, N_samples=N),
                                  TL.SyntheticDataset(sb, N_samples=N)]))
    h5, st = stores[kind if kind in ('few', 'nms') else 'a']
    j = JL.SyntheticDataset(h5, N_samples=N, **kw)
    t = TL.SyntheticDataset(st, N_samples=N, **kw)
    if kind == 'temporal':
        for d in (j, t):
            d.temp_validity = np.array([0, 1, 1, 0, 1, 1])
        j, t = JD.TemporalDatasetWrapper(j), TD.TemporalDatasetWrapper(t)
    return j, t


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


RANKS = [(0, 2), (1, 2)]


@pytest.mark.parametrize('kind', ['frames', 'temporal', 'concat', 'few'])
@pytest.mark.parametrize('host_slice', RANKS, ids=['p0', 'p1'])
def test_get_batch_host_slice_bit_equal(stores, kind, host_slice):
    j, t = _datasets(stores, kind)
    for seed, idxs in ((0, [0, 2, 5]), (1, [1, 1, 3, 4])):
        a = j.get_batch(np.array(idxs), np.random.default_rng(seed),
                        host_slice=host_slice)
        b = t.get_batch(np.array(idxs), np.random.default_rng(seed),
                        host_slice=host_slice)
        _assert_batches_equal(a, b)


@pytest.mark.parametrize('kind', ['frames', 'concat', 'few', 'nms'])
@pytest.mark.parametrize('host_slice', RANKS, ids=['p0', 'p1'])
def test_get_item_host_slice_bit_equal(stores, kind, host_slice):
    """The per-image path (``sample_pixels``), its NMS draw and its
    too-few-pixels fallback on the rank's own stream."""
    j, t = _datasets(stores, kind, **({'N_nms': 2} if kind == 'nms' else {}))
    for q in (0, 4):
        a = j.get_item(q, np.random.default_rng(q), host_slice=host_slice)
        b = t.get_item(q, np.random.default_rng(q), host_slice=host_slice)
        _assert_batches_equal(a, b)


@pytest.mark.parametrize('host_slice', RANKS, ids=['p0', 'p1'])
def test_prefetcher_rank_batches_bit_equal(stores, host_slice):
    j, t = _datasets(stores, 'concat', N=6)
    p, n = host_slice
    pj = JPL.Prefetcher(j, N_images=3, n_workers=2, seed=5, N_iter=3,
                        process_index=p, process_count=n)
    pt = TPL.Prefetcher(t, N_images=3, n_workers=2, seed=5, N_iter=3,
                        process_index=p, process_count=n)
    try:
        bj, bt = list(pj), list(pt)
    finally:
        pj.stop()
        pt.stop()
    assert len(bj) == len(bt) == 3
    for a, b in zip(bj, bt):
        _assert_batches_equal(a, b)


def test_load_data_splits_the_per_image_budget():
    cfg = TConfig(N_rand=24, N_sample_images=3)
    with pytest.raises(ValueError, match='do not split over 3 ranks'):
        TL.get_dataset(cfg, process_count=3)


# ---- the sharded renderer ---------------------------------------------------

@pytest.fixture(scope='module')
def scene():
    """``test_sharded_eval.py``'s scene in the port (its own draw of the
    weights): a 24x24 image whose box holds rays that miss the
    cylinder, so the chunk's mean near/far matters."""
    rng = np.random.RandomState(0)
    rest = SMPL_REST_POSE * 0.0022
    bones = rng.normal(scale=0.1, size=(2, 24, 3)).astype(np.float32)
    l2ws = np.stack([get_smpl_l2ws_np(b, rest) for b in bones])
    kps = l2ws[..., :3, 3].astype(np.float32)
    skts = np.linalg.inv(l2ws).astype(np.float32)
    cyls = get_kp_bounding_cylinder(kps, ext_scale=0.001, head='-y')
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.7
    cfg = dict(use_cutoff=True, cutoff_viewdir=True, cutoff_inputs=True,
               use_viewdirs=True, multires=3, multires_views=2,
               netdepth=2, netwidth=16, N_samples=8, N_importance=4,
               opt_framecode=True, ext_scale=0.001)
    spec = dict(cfg=cfg, n_frames=2, rest=rest, kps=kps, bones=bones,
                near=0., far=1.)
    rc = t_build(TConfig(**cfg), n_framecodes=2)
    params = init_raycaster_params(torch.Generator().manual_seed(1), rc,
                                   TConfig(**cfg))
    est = embed_state(TConfig(**cfg), rc, 5000)
    image = dict(H=24, W=24, focal=20.0, c2w=c2w, kp=kps[0], skt=skts[0],
                 bone=bones[0], cyl=cyls[0], cam_idx=0)
    return dict(spec=spec, rc=rc, params=params, est=est, image=image)


def test_two_rank_render_matches_one_rank(scene, ranks):
    """Chunks of 64 and 60 rays over two ranks: the frame of one rank
    at ``test_sharded_eval.py``'s bars."""
    results = ranks['render']
    for chunk, got in zip((64, 60), results[0]['images']):
        one = ImageRenderer(scene['rc'], scene['params'], scene['est'],
                            chunk=chunk, device='cpu').render_image(
                                **scene['image'])
        assert one['acc'].max() > 1e-3      # the frame has content
        np.testing.assert_allclose(got['rgb'], one['rgb'], atol=1e-5)
        np.testing.assert_allclose(got['disp'], one['disp'], atol=1e-4)
        np.testing.assert_allclose(got['acc'], one['acc'], atol=1e-5)
    for a, b in zip(results[0]['images'], results[1]['images']):
        for k in ('rgb', 'disp', 'acc'):
            assert np.array_equal(a[k], b[k])


def test_render_chunk_must_split_over_the_ranks(scene):
    for chunk in (60, 64):
        ImageRenderer(scene['rc'], scene['params'], scene['est'],
                      chunk=chunk, device='cpu', mesh=S.RayMesh(0, 2))
    with pytest.raises(ValueError, match='chunk 63'):
        ImageRenderer(scene['rc'], scene['params'], scene['est'], chunk=63,
                      device='cpu', mesh=S.RayMesh(0, 2))
