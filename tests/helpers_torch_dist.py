"""Multi-rank workers for the port's distributed tests, on the CPU over
gloo.  This module imports no JAX: spawned workers import it (and only
it) by name, so a test module that imports JAX is never re-imported in a
worker.

``Workers(fn, world, tmp_path, *args)`` starts `world` processes that
rendezvous through a ``file://`` store under `tmp_path` (never a fixed
port: test workers run side by side), each with one torch thread; each
calls ``fn(rank, world, *args)`` and its return value comes back pickled
to ``join()``, while the caller works meanwhile (the JAX side).  The
parent joins them against one deadline and kills them all when it
passes, so a stuck collective fails the test in seconds instead of
hanging the run.
"""
import copy
import dataclasses
import faulthandler
import os
import pickle
import time
import traceback
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import distributed as dist
from torch import multiprocessing as mp

from skypilot_tpu_torch.analysis import sanitizers

DEFAULT_TIMEOUT = 150.0


class Workers:
    """`world` gloo ranks running fn(rank, world, *args); ``join()`` waits
    for them (the caller may work meanwhile: e.g. compute the JAX side)."""

    def __init__(self, fn, world: int, tmp_path, *args,
                 timeout: float = DEFAULT_TIMEOUT):
        ctx = mp.get_context('spawn')
        self.name, self.world = fn.__name__, world
        self.out = os.path.join(str(tmp_path),
                                f'dist_{fn.__name__}_{time.time_ns()}')
        os.makedirs(self.out)
        self.procs = [ctx.Process(target=_entry, daemon=True,
                                  args=(fn.__name__, rank, world, self.out,
                                        args, timeout))
                      for rank in range(world)]
        for p in self.procs:
            p.start()
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout

    def join(self) -> List[Any]:
        """The ranks' results in rank order.  Raises with the worker's
        traceback if one failed, and TimeoutError (after killing every
        worker) if they are not all done by the deadline."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.kill()
        for p in alive:
            p.join()
        if alive:
            raise TimeoutError(f'{self.name}: {len(alive)} of {self.world} '
                               f'ranks still running after {self.timeout} '
                               's; killed')
        results = []
        for rank in range(self.world):
            path = os.path.join(self.out, f'rank{rank}.pkl')
            if not os.path.exists(path):
                raise RuntimeError(
                    f'{self.name}: rank {rank} exited '
                    f'({self.procs[rank].exitcode}) with no result')
            with open(path, 'rb') as f:
                res = pickle.load(f)
            if 'error' in res:
                raise RuntimeError(f'{self.name} rank {rank} failed:\n'
                                   f'{res["error"]}')
            results.append(res['ok'])
        return results


def _entry(name: str, rank: int, world: int, out: str, args,
           timeout: float) -> None:
    torch.set_num_threads(1)
    # A stuck rank prints where it is stuck before the parent kills it.
    faulthandler.dump_traceback_later(max(timeout - 5.0, 1.0), exit=False)
    res: Dict[str, Any]
    try:
        dist.init_process_group(
            'gloo', init_method='file://' + os.path.join(out, 'store'),
            rank=rank, world_size=world)
        res = {'ok': globals()[name](rank, world, *args)}
    except BaseException:  # noqa: BLE001 -- shipped to the parent
        res = {'error': traceback.format_exc()}
    with open(os.path.join(out, f'rank{rank}.pkl.tmp'), 'wb') as f:
        pickle.dump(res, f)
    os.replace(os.path.join(out, f'rank{rank}.pkl.tmp'),
               os.path.join(out, f'rank{rank}.pkl'))
    if dist.is_initialized():
        dist.destroy_process_group()


def conservation_errors(eng):
    """The paged pool's block-conservation law, as the port's sanitizer
    checks it (``analysis.sanitizers.check_block_conservation``: every
    block's refcount equals its holders -- slot table entries, radix
    nodes, registered prefix entries, the dump block's own ref -- the free
    list is exactly the unheld blocks, and the host tier's byte ledger
    balances), read without taking the engine's lock (a window audit runs
    inside it), plus one clause the sanitizer lacks: idle slots (neither
    active nor mid-chunked prefill) hold nothing.  Returns error strings
    (empty = ok)."""
    errors = []
    for slot in range(eng.cfg.num_slots):
        n = int(eng._slot_nblocks[slot])
        if n and eng._slots[slot] is None and slot not in eng._chunking:
            errors.append(f'idle slot {slot} holds {n} blocks')
    try:
        sanitizers.check_block_conservation(eng, lock=False)
    except sanitizers.BlockLeakError as e:
        errors.extend(e.errors)
    return errors


class WindowAudit:
    """Checks conservation_errors after every decode window the engine
    runs (offline or on the serving thread) while in the with-block;
    violations are collected, not raised, so the serving loop's
    containment cannot swallow them.  .windows counts the checks."""

    def __init__(self, eng):
        self.eng, self.errors, self.windows = eng, [], 0

    def __enter__(self):
        step = self.eng._step

        def audited():
            try:
                step()
            finally:
                self.windows += 1
                self.errors.extend(conservation_errors(self.eng))

        self.eng._step = audited
        return self

    def __exit__(self, *exc):
        del self.eng._step          # back to the class's method
        self.errors.extend(conservation_errors(self.eng))
        return False


def _np(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


# ---------------------------------------------------------- the trainer


@dataclasses.dataclass
class TrainLeg:
    """One trainer run: the mesh degrees, the model (with `overrides` on
    its registry config, f32), TrainConfig fields, the starting
    state_dict and the global token batches of each step.  With `ckpt`
    set the run checkpoints there every step and `resume_at` steps are
    trained by a first Trainer, the rest by a second that resumes (with
    `resume_mesh`, another shape, if given)."""
    name: str
    mesh: Dict[str, int]
    model: str
    overrides: Dict[str, Any]
    train: Dict[str, Any]
    params: Dict[str, np.ndarray]
    batches: List[np.ndarray]
    ckpt: str = ''
    resume_at: int = 0
    resume_mesh: Dict[str, int] = None
    # Feed each rank only its rows (ShardInfo.current(mesh) and
    # shard_batch), as a multi-process data loader does.
    local_rows: bool = False
    # Parameters whose rank-local shards each rank returns (after setup,
    # before the first step).
    local_names: Tuple[str, ...] = ()


def _trainer(leg: TrainLeg, mesh: Dict[str, int]):
    from skypilot_tpu_torch.models import registry
    from skypilot_tpu_torch.parallel.mesh import MeshSpec
    from skypilot_tpu_torch.train import trainer as tt
    cfg = dataclasses.replace(registry.get_model_config(leg.model),
                              dtype=torch.float32, **leg.overrides)
    extra = {'checkpoint_dir': leg.ckpt, 'checkpoint_every': 1} \
        if leg.ckpt else {}
    tr = tt.Trainer(tt.TrainConfig(model=leg.model, mesh=MeshSpec(**mesh),
                                   **leg.train, **extra), cfg, device='cpu')
    tr.setup(params={k: torch.from_numpy(v) for k, v in leg.params.items()})
    return tr


def _resumed(leg: TrainLeg):
    """The second Trainer of a resume leg, and the number of files this
    rank read with ``torch.load`` while it set up (broadcast objects are
    unpickled through it from memory: those are not counted)."""
    loads, real = [], torch.load

    def counted(f, *args, **kwargs):
        if isinstance(f, (str, os.PathLike)):
            loads.append(f)
        return real(f, *args, **kwargs)

    torch.load = counted
    try:
        tr = _trainer(leg, leg.resume_mesh or leg.mesh)
    finally:
        torch.load = real
    assert tr.state.step == leg.resume_at, tr.state.step
    return tr, len(loads)


def _local(t: torch.Tensor) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    t = t.detach()
    return (t.to_local() if isinstance(t, DTensor) else t).numpy().copy()


def trainer_legs(rank: int, world: int, legs: List[TrainLeg]) -> List[Dict]:
    """Each leg's per-step loss, grad_norm and (Mixtral) router_aux_loss,
    (rank 0) its final parameters gathered whole and the element count of
    its optimizer's moments, (a resume leg) this rank's ``torch.load``
    calls while it resumed, and this rank's shards of the leg's
    `local_names`; every mesh here spans the world."""
    out = []
    for leg in legs:
        losses, norms, aux, loads = [], [], [], None
        tr = _trainer(leg, leg.mesh)
        named = dict(tr.state.model.named_parameters())
        local = {n: _local(named[n]) for n in leg.local_names}
        for i, tokens in enumerate(leg.batches):
            if leg.resume_at and i == leg.resume_at:
                tr, loads = _resumed(leg)
            if leg.local_rows:
                from skypilot_tpu_torch.data.loader import (ShardInfo,
                                                            shard_batch)
                shard = ShardInfo.current(tr.mesh)
                n = len(tokens) // shard.count
                batch = shard_batch(
                    {'tokens': tokens[shard.index * n:(shard.index + 1) * n]},
                    tr.mesh)
            else:
                batch = {'tokens': torch.from_numpy(tokens)}
            m = tr._step_fn(tr.state, batch)
            tr.save(tr.state.step)
            losses.append(float(m['loss']))
            norms.append(float(m['grad_norm']))
            if 'router_aux_loss' in m:
                aux.append(float(m['router_aux_loss']))
        model_sd, optim_sd = tr._full_state()
        moments = sum(v.numel() for st in optim_sd.get('state', {}).values()
                      for k, v in st.items() if k != 'step')
        out.append({'loss': losses, 'grad_norm': norms,
                    'router_aux_loss': aux, 'loads': loads,
                    'params': _np(model_sd) if rank == 0 else None,
                    'moments': moments if rank == 0 else None,
                    'local': local})
    return out


def finetune_example(rank: int, world: int, runs: List[Dict]) -> List:
    """``examples/finetune_llama31_torch.py``'s ``main()`` on this rank,
    once for each run's (env, argv), one after another: the step each
    run's trainer ended at."""
    import importlib.util
    import sys
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'examples',
        'finetune_llama31_torch.py')
    spec = importlib.util.spec_from_file_location('finetune_twin', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = []
    for run in runs:
        os.environ.update(run['env'])
        argv, sys.argv = sys.argv, ['finetune_llama31_torch.py',
                                    *run['argv']]
        try:
            trainer = mod.main()
        finally:
            sys.argv = argv
        out.append(trainer.state.step)
    return out


# ------------------------------------------------------------ the dryrun


def dryrun(rank: int, world: int, params=None) -> Dict[str, Any]:
    """The port's dryrun_multichip(world) on the CPU: the training legs'
    losses and the lines rank 0 printed.  `params`: per-leg numpy
    state_dicts."""
    from skypilot_tpu_torch.entry import dryrun_multichip
    if params is not None:
        params = {leg: {k: torch.from_numpy(v) for k, v in sd.items()}
                  for leg, sd in params.items()}
    lines: List[str] = []
    losses = dryrun_multichip(world, device='cpu', params=params,
                              log=lines.append if rank == 0
                              else (lambda _: None))
    return {'losses': losses, 'lines': lines}


# ------------------------------------------------- sequence parallelism


def seq_attention(rank: int, world: int, cases: List[Dict]) -> List[Dict]:
    """Each case ({'mode', 'causal', 'q', 'k', 'v', 'dout'}: global
    [B, H, S, D] arrays) on a MeshSpec(seq=world) mesh: this rank's
    sequence block through ring or Ulysses attention, its output and the
    gradients of sum(out * dout) for its q, k and v blocks."""
    from skypilot_tpu_torch.ops import ring_attention as ra
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(seq=world), 'cpu')
    out = []
    for case in cases:
        blk = slice(rank * case['q'].shape[2] // world,
                    (rank + 1) * case['q'].shape[2] // world)
        q, k, v = (torch.from_numpy(case[n][:, :, blk]).requires_grad_(True)
                   for n in ('q', 'k', 'v'))
        with mesh_lib.mesh_context(mesh):
            o = ra.sequence_parallel_attention(q, k, v, causal=case['causal'],
                                               mode=case['mode'])
            (o * torch.from_numpy(case['dout'][:, :, blk])).sum().backward()
        out.append({'out': o.detach().numpy(), 'dq': q.grad.numpy(),
                    'dk': k.grad.numpy(), 'dv': v.grad.numpy()})
    try:
        with mesh_lib.mesh_context(mesh):
            ra.ulysses_attention(torch.zeros(1, 3, 4, 8),
                                 torch.zeros(1, 3, 4, 8),
                                 torch.zeros(1, 3, 4, 8))
        out.append(None)
    except ValueError as e:
        out.append(str(e))
    return out


# ----------------------------------------------------------- pipelining


def pipeline_stages(rank: int, world: int, w: np.ndarray, b: np.ndarray,
                    mbs: np.ndarray) -> Dict:
    """``pipeline`` over MeshSpec(stage=world) with stage s applying
    tanh(x @ w[s] + b[s]): the outputs (every stage gets them) and the
    gradients of sum(out ** 2) (each stage weighing its copy 1/S) for
    this stage's w and b, and (stage 0) for the microbatches."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel.pipeline import pipeline
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(stage=world), 'cpu')
    params = {'w': torch.from_numpy(w[rank]).requires_grad_(True),
              'b': torch.from_numpy(b[rank]).requires_grad_(True)}
    x = torch.from_numpy(mbs).requires_grad_(True)

    def stage_fn(p, h, consts):
        return torch.tanh(h @ p['w'] + p['b'])

    out = pipeline(stage_fn, params, x, (), mesh)
    # Every stage computes the loss; each weighs it 1/S, so it counts once.
    ((out ** 2).sum() / world).backward()
    try:
        pipeline(stage_fn, params, x[:world - 1], (), mesh)
        short = None
    except ValueError as e:
        short = str(e)
    return {'out': out.detach().numpy(), 'dw': params['w'].grad.numpy(),
            'db': params['b'].grad.numpy(),
            'dx': x.grad.numpy() if rank == 0 else None, 'short': short}


# ------------------------------------------------------------ task loops


def task_steps(rank: int, world: int, family: str, config: Dict,
               params: Dict[str, np.ndarray], batches: List[List[Dict]],
               lr: float, steps: int) -> Dict:
    """BERT's or ResNet's step over MeshSpec(data=world) from `params`,
    each rank taking its own batches (`batches[rank]`): the averaged loss
    and accuracy of each step, and rank 0's final state_dict (with the
    running statistics).  Then the loop itself (``finetune_bert`` or
    ``train_resnet``) for 2 steps on the same group: each rank's first
    loss and a digest of its final parameters."""
    from skypilot_tpu_torch.models.resnet import ResNetConfig
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import tasks
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(data=world), 'cpu')
    sd = {k: torch.from_numpy(v) for k, v in params.items()}
    if family == 'bert':
        from skypilot_tpu_torch.models import registry
        cfg = dataclasses.replace(registry.get_model_config(config['name']),
                                  dtype=torch.float32)
        state = tasks.bert_setup(cfg, lr, device='cpu', params=sd,
                                 mesh=mesh)
        step = tasks.bert_step
    else:
        cfg = ResNetConfig(name='t', dtype=torch.float32, **config)
        state = tasks.resnet_setup(cfg, lr, 0.9, steps, device='cpu',
                                   params=sd, mesh=mesh)
        step = tasks.resnet_step
    losses, accs = [], []
    for batch in batches[rank]:
        loss, acc = step(state, batch)
        losses.append(loss.item())
        accs.append(acc.item())
    loop = (tasks.finetune_bert('bert-debug', steps=2, batch_size=8,
                                seq_len=16, device='cpu', log=lambda _: None)
            if family == 'bert' else
            tasks.train_resnet('resnet18-debug', steps=2, batch_size=8,
                               image_size=16, num_classes=4, device='cpu',
                               log=lambda _: None))
    digest = sum(float(p.double().sum())
                 for p in loop['state'].model.parameters())
    return {'loss': losses, 'acc': accs,
            'state': _np(state.model.state_dict()) if rank == 0 else None,
            'loop_first_loss': loop['first_loss'], 'loop_digest': digest,
            'loop_mesh': loop['state'].mesh.shape}


# ------------------------------------------------- tensor-parallel serving


@dataclasses.dataclass
class ServeRun:
    """One tensor-parallel engine over the world's ranks
    (``MeshSpec(fsdp=world // tensor, tensor=tensor)``, or the degrees of
    `mesh`): `family` ('llama' | 'mixtral' | 'gpt2') at `geometry` (f32),
    InferConfig fields `infer`, the full state_dict `params` (numpy), and
    the `ops` rank 0 runs on it in order, each (name, *args) of
    ``_OPS``.  With `audit` the block conservation law is checked after
    every window (rank 0)."""
    name: str
    family: str
    geometry: Dict[str, Any]
    infer: Dict[str, Any]
    params: Dict[str, np.ndarray]
    ops: List[tuple]
    tensor: int = 2
    audit: bool = False
    mesh: Dict[str, int] = None


def _result(r) -> Dict[str, Any]:
    return {'tokens': list(r.output_tokens), 'finish': r.finish_reason,
            'logprobs': list(r.logprobs or []), 'error': r.error,
            'prompt_logprobs': list(r.prompt_logprobs or [])}


def _requests(eng_mod, reqs):
    return [eng_mod.Request(**r) for r in reqs]


def _op_generate(eng, reqs):
    from skypilot_tpu_torch.infer import engine as em
    return [_result(r) for r in eng.generate(_requests(em, reqs))]


def _op_served(eng, reqs, gaps=None):
    from skypilot_tpu_torch.infer import engine as em
    return [_result(r) for r in eng.generate_served(_requests(em, reqs),
                                                    gaps)]


def _op_drift(eng):
    """Plant a cache leaf holding every kv head on rank 0 and return the
    shard check's error (None if it passed), the leaf restored after."""
    from skypilot_tpu_torch.analysis import sanitizers
    k, v = eng.cache[0]
    shape = list(k.shape)
    shape[1] = eng.model_config.num_kv_heads
    eng.cache[0] = (torch.zeros(shape, dtype=k.dtype), v)
    try:
        sanitizers.check_shard_layout(eng)
        return None
    except sanitizers.ShardLayoutError as e:
        return str(e)
    finally:
        eng.cache[0] = (k, v)


def _op_register(eng, name, src):
    """Register adapter `name` from the .npz at path `src` (read on rank 0)
    or from the tree `src`."""
    from skypilot_tpu_torch.train import lora
    return eng.register_adapter(name, lora.load_adapter_npz(src)
                                if isinstance(src, str) else src)


def _op_register_error(eng, name, tree):
    """register_adapter's refusal of `tree`: (type name, text), or None."""
    try:
        eng.register_adapter(name, tree)
        return None
    except (KeyError, ValueError) as e:
        return type(e).__name__, str(e)


def _planted(eng, module, leaf, value):
    """The shard check's error (None if it passed) with `module`'s `leaf`
    replaced by `value` on rank 0, the leaf restored after."""
    from skypilot_tpu_torch.analysis import sanitizers
    old = getattr(module, leaf)
    setattr(module, leaf, torch.nn.Parameter(value, requires_grad=False))
    try:
        sanitizers.check_shard_layout(eng)
        return None
    except sanitizers.ShardLayoutError as e:
        return str(e)
    finally:
        setattr(module, leaf, old)


def _op_adapter_drift(eng):
    """Plant layer 0's q_proj lora_b stack at its full width on rank 0."""
    shape = eng._full_shapes['layers.0.attn.q_proj_lora.lora_b']
    return _planted(eng, eng.model.layers[0].attn.q_proj_lora, 'lora_b',
                    torch.zeros(shape))


def _op_qkv_drift(eng):
    """Plant GPT-2 layer 0's c_attn rows shifted by one head on rank 0
    (the shapes unchanged)."""
    attn = eng.model.h[0].attn
    w = attn.c_attn.weight.detach()
    return _planted(eng, attn.c_attn, 'weight',
                    w.roll(eng.model_config.head_dim_, 0).clone())


def _op_evict(eng, need):
    """Evict `need` radix blocks now (spilling them to the host tier)."""
    with eng._lock:
        freed = eng._evict_radix(need)
        if eng._host_tier is not None:
            eng._host_tier.finalize()
    return freed


def _op_qos_park(eng, batch, interactive):
    """QoS preemption at a chunk boundary: a long batch prompt starts
    chunking in the serving loop and an interactive request arrives
    between two chunk rounds (queued from inside the first round); the
    batch prompt is parked and resumes from its radix blocks."""
    import queue as queue_mod
    import threading
    from skypilot_tpu_torch.infer import engine as em
    q: 'queue_mod.Queue' = queue_mod.Queue()
    results, done = {}, threading.Event()
    inter = em.Request(**interactive)
    real = eng._chunk_round
    sent = []

    def chunk_round():
        moved = real()
        if moved and not sent:
            sent.append(1)
            q.put(inter)
        return moved

    def deliver(res):
        results[res.request_id] = res
        if len(results) == 2:
            done.set()

    eng._chunk_round = chunk_round
    stop = threading.Event()
    loop = threading.Thread(target=eng.generate_stream,
                            args=(q, deliver, stop), daemon=True)
    try:
        q.put(em.Request(**batch))
        loop.start()
        assert done.wait(timeout=60), 'qos park/resume timed out'
    finally:
        stop.set()
        loop.join(timeout=30)
        del eng._chunk_round
    return {rid: _result(r) for rid, r in results.items()}


def _op_shard_sanitizer(eng, on: bool):
    """SKYTPU_SHARD_SANITIZER on (counting every shard-layout check from
    then on in ``eng._shard_checks``, the serving loop's quiesce hook's
    included) or off."""
    from skypilot_tpu_torch.analysis import sanitizers
    if not on:
        os.environ.pop('SKYTPU_SHARD_SANITIZER', None)
        return
    os.environ['SKYTPU_SHARD_SANITIZER'] = '1'
    eng._shard_checks = [0]
    check = sanitizers.check_shard_layout

    def counted(engine):
        eng._shard_checks[0] += 1
        return check(engine)

    sanitizers.check_shard_layout = counted


_OPS = {
    'generate': _op_generate,
    'served': _op_served,
    'register_prefix': lambda eng, tokens: eng.register_prefix(tokens),
    'export': lambda eng, *a: eng.export_hot_prefixes(*a),
    'adopt': lambda eng, payload: eng.adopt_prefixes(payload),
    'stats': lambda eng: eng.stats(),
    'kv_health': lambda eng: eng.kv_health(),
    'shard': lambda eng: __import__(
        'skypilot_tpu_torch.analysis.sanitizers',
        fromlist=['x']).check_shard_layout(eng),
    'drift': _op_drift,
    'register': _op_register,
    'register_error': _op_register_error,
    'adapter_drift': _op_adapter_drift,
    'qkv_drift': _op_qkv_drift,
    'evict': _op_evict,
    'qos_park': _op_qos_park,
    'shard_sanitizer': _op_shard_sanitizer,
    'attr': lambda eng, name: copy.deepcopy(getattr(eng, name)),
    'tier': lambda eng: eng._host_tier_section(),
}


def _serve_engine(run: ServeRun, world: int):
    from skypilot_tpu_torch.infer import engine as em
    from skypilot_tpu_torch.models.gpt2 import GPT2Config
    from skypilot_tpu_torch.models.llama import LlamaConfig
    from skypilot_tpu_torch.models.mixtral import MixtralConfig
    from skypilot_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    cls = {'llama': LlamaConfig, 'mixtral': MixtralConfig,
           'gpt2': GPT2Config}[run.family]
    cfg = cls(**run.geometry, dtype=torch.float32)
    mesh = make_mesh(MeshSpec(**(run.mesh or dict(
        fsdp=world // run.tensor, tensor=run.tensor))), 'cpu')
    # Only rank 0's weights are read: the engine sends each rank its slice.
    params = ({k: torch.from_numpy(v) for k, v in run.params.items()}
              if dist.get_rank() == 0 else None)
    return em.InferenceEngine(
        cfg, em.InferConfig(**run.infer), params=params,
        generator=torch.Generator().manual_seed(0), device='cpu',
        mesh=mesh)


def tp_serving(rank: int, world: int, runs: List[ServeRun]) -> List[Dict]:
    """Each run's engine on every rank: rank 0 runs the ops and returns
    their values (and, with `audit`, the conservation errors); every rank
    returns its cache's kv heads and the tokens it sampled (every
    ``_pack_head`` call's choice, in order)."""
    out = []
    for run in runs:
        eng = _serve_engine(run, world)
        sampled: List[List[int]] = []
        pack = eng._pack_head

        def recorded(logits, temps, _pack=pack, _log=sampled):
            chosen, head = _pack(logits, temps)
            _log.append(chosen.tolist())
            return chosen, head

        eng._pack_head = recorded
        res: Dict[str, Any] = {'cache_heads': int(eng.cache[0][0].shape[1]),
                               'sampled': sampled}
        if rank == 0:
            values, errors = [], []
            try:
                ctx = WindowAudit(eng) if run.audit else None
                if ctx is not None:
                    ctx.__enter__()
                try:
                    for name, *args in run.ops:
                        values.append(_OPS[name](eng, *args))
                finally:
                    if ctx is not None:
                        ctx.__exit__(None, None, None)
                        errors = ctx.errors
            finally:
                eng.shutdown()
            res.update(values=values, conservation=errors)
        else:
            eng.serve_worker()
        out.append(res)
    return out


def tp_protocol(rank: int, world: int, run: ServeRun, idle_s: float,
                short_s: float) -> Dict[str, Any]:
    """The dispatch protocol's two failure cases on one engine.

    Idle: the control group is made while gloo's default timeout is
    `short_s` (standing in for its 30 minutes), then rank 0 generates,
    idles `idle_s` > `short_s` and generates again: rank 1 must still be
    waiting for it.  Then a failure on rank 1 alone (its ``_zero_cache``
    raises): rank 0's dispatch of it must raise, and so must the next
    one, not serve from a shard that missed an op.  Rank 0 returns both
    generations and the two errors; rank 1 the error that ended
    ``serve_worker``."""
    import datetime
    from torch.distributed import distributed_c10d as c10d

    from skypilot_tpu_torch.infer import engine as em
    from skypilot_tpu_torch.infer import tp as tp_lib
    default = c10d.default_pg_timeout
    c10d.default_pg_timeout = datetime.timedelta(seconds=short_s)
    try:
        tp_lib.control_group()
    finally:
        c10d.default_pg_timeout = default
    eng = _serve_engine(run, world)
    if rank != 0:
        def boom(*_a, **_k):
            raise RuntimeError('planted worker-only failure')

        em.InferenceEngine._zero_cache.raw = boom
        try:
            eng.serve_worker()
        except RuntimeError as e:
            return {'worker_error': str(e)}
        return {'worker_error': None}
    reqs = [dict(tokens=[4, 5, 6, 7], max_new_tokens=6)]
    out: Dict[str, Any] = {'first': _op_generate(eng, reqs)}
    time.sleep(idle_s)
    out['after_idle'] = _op_generate(eng, reqs)
    for key, op in (('failed', eng._zero_cache),
                    ('next', lambda: _op_generate(eng, reqs))):
        try:
            out[key] = op()
        except RuntimeError as e:
            out[key] = str(e)
    eng.shutdown()
    return out

