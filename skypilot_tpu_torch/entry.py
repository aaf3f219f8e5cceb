"""Entry points of the port, the twins of ``__graft_entry__``'s: ``entry``,
the no-cache forward of ``llama-1b`` over tokens ``[1, 1024]``, whose
attention runs through the Hopper flash-attention kernel; and
``dryrun_multichip``, one train step of each parallel leg and the
tensor-parallel serving legs over the process group's ranks."""
import math
import os
import queue
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models.convert import init_params
from skypilot_tpu_torch.models.llama import Llama
from skypilot_tpu_torch.models.registry import get_model_config


def entry(device=None) -> Tuple[Callable, Tuple]:
    """Returns (forward, (model, tokens)): ``forward(model, tokens)`` gives
    logits [1, 1024, 32000] f32.  Random weights drawn from a
    ``torch.Generator`` seeded with 0.  device None means the card."""
    device = resolve_device(device)
    config = get_model_config('llama-1b')
    model = Llama(config, device=device).eval()
    model.load_state_dict(init_params(
        config, torch.Generator(device=device).manual_seed(0)))
    tokens = torch.zeros((1, 1024), dtype=torch.long, device=device)

    def forward(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(tokens)

    return forward, (model, tokens)


def dryrun_config(device: torch.device):
    """The dryrun's tiny llama: the JAX dryrun's config, on the card at 4x
    the width (hidden 512, MLP 1024: head_dim 64, where the Hopper
    kernels start; the JAX config's 16 is below every kernel's)."""
    from skypilot_tpu_torch.models.llama import LlamaConfig
    wide = device.type == 'cuda'
    return LlamaConfig(name='dryrun', vocab_size=512,
                       hidden_size=512 if wide else 128,
                       intermediate_size=1024 if wide else 256,
                       num_layers=2, num_heads=8, num_kv_heads=4,
                       max_seq_len=128, tie_embeddings=True)


def dryrun_multichip(n_devices: int, device=None,
                     params: Optional[Dict[str, Dict]] = None,
                     log: Callable[[str], None] = print
                     ) -> Dict[str, float]:
    """The twin of ``__graft_entry__.dryrun_multichip``: on a process group
    of `n_devices` ranks (started from the env, or a one-rank group), one
    train step of each leg on the reference's tiny config, each asserting
    a finite loss and printing the JAX line:

    - dp/fsdp/tp: ``MeshSpec(data, fsdp, tensor)`` as the reference picks
      it from the device count, with grad accumulation 2;
    - sp: ring attention over ``seq=2``; pp: GPipe over ``stage=2``
      (both skipped, with the reason printed, when the rank count is odd,
      as the reference skips them);
    - ep: Mixtral with its experts sharded over 'tensor'.

    Then the serving legs (``serve_legs``): serve-tp and
    serve-tp-lookahead, skipped with the reason on an odd rank count.

    `params` maps a leg ('dp', 'sp', 'pp', 'ep') to its starting
    state_dict (e.g. the JAX legs' weights through
    ``convert.state_dict_from_jax``); by default each is drawn from the
    seed of the reference's PRNG key.  Returns each run training leg's
    loss."""
    from torch import distributed as dist

    from skypilot_tpu_torch.parallel.mesh import ensure_process_group
    device = ensure_process_group(device)
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f'need {n_devices} ranks, have {world}')
    params = params or {}
    config = dryrun_config(device)
    losses: Dict[str, float] = {}
    _train_legs(n_devices, device, config, params, log, losses)
    serve_legs(n_devices, device, config, log)
    return losses


def _train_legs(n_devices, device, config, params, log, losses) -> None:
    from skypilot_tpu_torch.models.mixtral import MixtralConfig
    from skypilot_tpu_torch.parallel.mesh import MeshSpec
    from skypilot_tpu_torch.train.trainer import Trainer, TrainConfig
    tensor = 2 if n_devices % 2 == 0 else 1
    rest = n_devices // tensor
    fsdp = math.gcd(rest, config.hidden_size)
    data = rest // fsdp
    if data == 1 and fsdp % 2 == 0:   # prefer exercising a data axis
        data, fsdp = 2, fsdp // 2
    spec = MeshSpec(data=data, fsdp=fsdp, tensor=tensor)
    dp_total = data * fsdp
    batch = max(8, 2 * dp_total)
    batch += (-batch) % (2 * dp_total)
    tokens = torch.zeros((batch, 65), dtype=torch.long, device=device)

    def leg(name, model_config, mesh, seed, **train):
        tr = Trainer(TrainConfig(model=model_config.name, batch_size=batch,
                                 seq_len=64, warmup_steps=1, total_steps=2,
                                 mesh=mesh, **train), model_config,
                     device=device)
        tr.setup(seed=seed, params=params.get(name))
        loss = float(tr._step_fn(tr.state, {'tokens': tokens})['loss'])
        assert math.isfinite(loss), f'non-finite loss in dryrun {name}'
        losses[name] = loss
        return loss

    loss = leg('dp', config, spec, 0, grad_accum_steps=2)
    log(f'dryrun_multichip ok: mesh={spec.shape} loss={loss:.3f}')
    if n_devices % 2 == 0:
        sp_spec = MeshSpec(data=data, fsdp=fsdp * tensor // 2, seq=2)
        loss = leg('sp', config, sp_spec, 0)
        log(f'dryrun sp ok: mesh={sp_spec.shape} loss={loss:.3f}')
        loss = leg('pp', config, MeshSpec(stage=2, data=n_devices // 2), 1,
                   pipeline_microbatches=2)
        log(f'dryrun pp ok: stages=2 loss={loss:.3f}')
    else:
        log(f'dryrun sp skipped: {n_devices} rank(s); seq=2 needs an even '
            'count')
        log(f'dryrun pp skipped: {n_devices} rank(s); stage=2 needs an '
            'even count')
    ep_config = MixtralConfig(
        name='dryrun-moe', vocab_size=512, hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size, num_layers=2,
        num_heads=8, num_kv_heads=4, num_experts=max(2, tensor),
        experts_per_token=2, max_seq_len=128, tie_embeddings=True)
    loss = leg('ep', ep_config, spec, 2)
    log(f'dryrun ep ok: experts={ep_config.num_experts} loss={loss:.3f}')


def serve_legs(n_devices: int, device: torch.device, config,
               log: Callable[[str], None] = print) -> None:
    """The serving legs of ``__graft_entry__.dryrun_multichip`` over the
    process group's ranks (every rank calls it; rank 0 serves and prints,
    the others run ``serve_worker``):

    - serve-tp: an engine over ``MeshSpec(fsdp=n / 2, tensor=2)`` whose q
      projection and cache hold half the heads, its greedy tokens those
      of the single engine on the same weights, and ``check_shard_layout``
      reporting tensor degree 2;
    - serve-tp-lookahead: the same through ``generate_stream`` with
      decode_steps 4, the adaptive window and lookahead, under the
      shard-layout sanitizer.

    Skipped with the reason on an odd rank count, as the reference skips
    them."""
    from torch import distributed as dist

    from skypilot_tpu_torch.analysis import sanitizers
    from skypilot_tpu_torch.infer.engine import (InferConfig,
                                                 InferenceEngine, Request)
    from skypilot_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    if n_devices % 2:
        log(f'dryrun serve-tp skipped: {n_devices} rank(s); tensor=2 needs '
            'an even count')
        log(f'dryrun serve-tp-lookahead skipped: {n_devices} rank(s); '
            'tensor=2 needs an even count')
        return
    rank0 = dist.get_rank() == 0
    icfg = dict(num_slots=2, max_cache_len=64, prefill_buckets=(8,),
                max_new_tokens=8, cache_dtype=torch.float32, decode_steps=2)
    # Rank 0's draws are the weights (the engine sends each rank its slice).
    weights = (init_params(config,
                           torch.Generator(device=device).manual_seed(3))
               if rank0 else None)
    prompts = [[4, 5, 6, 7], [9, 10, 11]]
    mesh = make_mesh(MeshSpec(fsdp=n_devices // 2, tensor=2), device.type)

    def requests(ids=False):
        return [Request(tokens=list(p), max_new_tokens=6,
                        request_id=str(i) if ids else None)
                for i, p in enumerate(prompts)]

    def served(infer, body):
        eng = InferenceEngine(config, InferConfig(**infer), params=weights,
                              device=device, mesh=mesh)
        if not rank0:
            eng.serve_worker()
            return None
        try:
            return body(eng)
        finally:
            eng.shutdown()

    want = None
    if rank0:
        single = InferenceEngine(config, InferConfig(**icfg),
                                 params=weights, device=device)
        want = [r.output_tokens for r in single.generate(requests())]

    def serve_tp(eng):
        attn = eng.model.layers[0].attn
        assert attn.q_proj.weight.shape[0] == \
            config.num_heads * config.head_dim_ // 2
        assert eng.cache[0][0].shape[1] == config.num_kv_heads // 2
        got = [r.output_tokens for r in eng.generate(requests())]
        assert got == want, f'serve-tp diverged: {got} vs {want}'
        report = sanitizers.check_shard_layout(eng)
        assert report['param_leaves_sharded'] > 0, report
        assert report['tensor_degree'] == 2, report
        log(f'dryrun serve-tp ok: mesh={mesh.shape} tokens={got[0][:4]} '
            f'shard_layout={report}')

    def serve_tp_lookahead(eng):
        results: Dict[str, object] = {}
        finished = threading.Event()

        def deliver(res):
            results[res.request_id] = res
            if len(results) == len(prompts):
                finished.set()

        rq: 'queue.Queue' = queue.Queue()
        stop = threading.Event()
        os.environ['SKYTPU_SHARD_SANITIZER'] = '1'
        loop = threading.Thread(target=eng.generate_stream,
                                args=(rq, deliver, stop), daemon=True)
        try:
            loop.start()
            for r in requests(ids=True):
                rq.put(r)
            assert finished.wait(timeout=900), \
                'serve-tp lookahead timed out'
        finally:
            stop.set()
            loop.join(timeout=60)
            os.environ.pop('SKYTPU_SHARD_SANITIZER', None)
        got = [results[str(i)].output_tokens for i in range(len(prompts))]
        assert got == want, f'serve-tp-lookahead diverged: {got} vs {want}'
        log(f'dryrun serve-tp-lookahead ok: window=4 adaptive+lookahead '
            f'tokens={got[0][:4]}')

    served(icfg, serve_tp)
    served({**icfg, 'decode_steps': 4, 'adaptive_decode_window': True,
            'decode_lookahead': True}, serve_tp_lookahead)
