"""The port's data-parallel task loops (skypilot_tpu_torch/train/tasks.py)
held against the JAX examples on the CPU, in f32: BERT's and ResNet's
steps over 2 gloo ranks, each rank drawing its own rows as the examples'
processes do, against the examples' steps (examples/finetune_bert.py,
examples/train_resnet.py) on a data=2 mesh over both ranks' rows --
ResNet's batch statistics over the global batch included -- and the
loops themselves over the same group."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import helpers_torch_dist as hd
from skypilot_tpu.parallel import mesh as jm
from skypilot_tpu_torch.models import convert
from test_torch_bert import _configs as bert_configs
from test_torch_bert import _jax_finetune_step, _jax_params
from test_torch_resnet import _configs as resnet_configs
from test_torch_resnet import _jax_train_step, _np_tree, _variables

TOL_LOSS = 1e-5          # relative, per-step loss
TOL_PARAMS = 1e-5        # absolute, parameters after 3 steps
TOL_STATS = 1e-5         # absolute, ResNet's running statistics
BERT_LR, RESNET_LR, STEPS = 1e-3, 0.1, 3


def _task_batches():
    """Each of 2 ranks' batches, as the examples draw them per process."""
    from skypilot_tpu_torch.train import tasks
    _, bcfg = bert_configs()
    bert = [[b for _, b in zip(range(STEPS), tasks.synthetic_bert_batches(
        np.random.default_rng(r), bcfg.vocab_size, 4, 16, bcfg.num_classes))]
        for r in range(2)]
    res = [[b for _, b in zip(range(STEPS), tasks.synthetic_resnet_batches(
        0, r, 3, 16, 4))] for r in range(2)]
    return bert, res


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('tasks')
    bert_b, res_b = _task_batches()
    bjcfg, btcfg = bert_configs()
    from skypilot_tpu.models import registry as jax_registry
    jbert = jax_registry.build_model(bjcfg, head='classify')
    bparams = _jax_params(jbert, bert_b[0][0]['tokens'], seed=5)
    bsd = {k: v.numpy() for k, v in convert.state_dict_from_jax(
        bparams, btcfg).items()}
    rjcfg, rtcfg = resnet_configs(num_classes=4)
    rvars = _variables(rjcfg, res_b[0][0]['images'], seed=2, perturb=False)
    rsd = {k: v.numpy() for k, v in convert.state_dict_from_jax(
        rvars['params'], rtcfg, rvars['batch_stats']).items()}
    bert = hd.Workers(hd.task_steps, 2, tmp, 'bert',
                      {'name': 'bert-debug'}, bsd, bert_b, BERT_LR, STEPS)
    res = hd.Workers(hd.task_steps, 2, tmp, 'resnet',
                     dict(stage_sizes=(1, 1, 1), width=8, num_classes=4),
                     rsd, res_b, RESNET_LR, STEPS)

    # The JAX examples' steps on a data=2 mesh, the ranks' rows joined.
    mesh = jm.make_mesh(jm.MeshSpec(data=2), devices=jax.devices()[:2])
    data = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
        'data'))

    def joined(ranks, i):
        return {k: jax.device_put(np.concatenate([r[i][k] for r in ranks]),
                                  data) for k in ranks[0][i]}

    opt, jstep = _jax_finetune_step(jbert, BERT_LR)
    jp = {'params': jax.tree.map(jnp.asarray, bparams)}
    js = opt.init(jp)
    jbert_out = []
    for i in range(STEPS):
        jp, js, loss, acc = jstep(jp, js, joined(bert_b, i))
        jbert_out.append((float(loss), float(acc)))
    ropt, rstep = _jax_train_step(rjcfg, RESNET_LR, STEPS)
    rstate = jax.tree.map(jnp.asarray, rvars)
    rs = ropt.init(rstate['params'])
    jres_out = []
    for i in range(STEPS):
        rstate, rs, loss, acc = rstep(rstate, rs, joined(res_b, i))
        jres_out.append((float(loss), float(acc)))
    want_bert = convert.state_dict_from_jax(_np_tree(jp['params']), btcfg)
    want_res = convert.state_dict_from_jax(
        _np_tree(rstate['params']), rtcfg, _np_tree(rstate['batch_stats']))
    return {'bert': (bert.join(), jbert_out, want_bert),
            'resnet': (res.join(), jres_out, want_res)}


@pytest.mark.parametrize('family', ['bert', 'resnet'])
def test_task_steps_over_two_ranks_match_the_examples(runs, family):
    """Three steps of each task's step over 2 ranks (each its own rows,
    the examples' per-process streams) against the JAX example's step on
    a data=2 mesh over both ranks' rows: loss 1e-5 relative and the same
    accuracy each step; parameters (and ResNet's running statistics:
    BatchNorm over the global batch) after them.  The loops themselves
    run data-parallel over the same group and keep the ranks'
    parameters identical."""
    ranks, jout, want = runs[family]
    for rank in ranks:
        np.testing.assert_allclose(rank['loss'], [x for x, _ in jout],
                                   rtol=TOL_LOSS)
        assert rank['acc'] == [a for _, a in jout]
    got = ranks[0]['state']
    assert got.keys() == want.keys()
    for key, t in got.items():
        tol = TOL_STATS if 'running' in key else TOL_PARAMS
        np.testing.assert_allclose(t, want[key].numpy(), rtol=0, atol=tol,
                                   err_msg=key)
    assert ranks[0]['loop_mesh'] == ranks[1]['loop_mesh']
    assert ranks[0]['loop_mesh']['data'] == 2
    assert ranks[0]['loop_first_loss'] == ranks[1]['loop_first_loss']
    assert ranks[0]['loop_digest'] == ranks[1]['loop_digest']
