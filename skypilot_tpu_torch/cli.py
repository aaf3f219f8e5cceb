"""Command line of the port: the ``infer`` group of the JAX package's
``skypilot_tpu/cli.py``, on argparse (the card's host has no ``click``).

    python -m skypilot_tpu_torch.cli infer serve --model llama-1b --port 8100
    python -m skypilot_tpu_torch.cli infer serve --profile latency
    python -m skypilot_tpu_torch.cli infer bench --model llama-1b --serving

``infer serve`` starts the port's HTTP server (``infer.server.run``) with
the reference command's options; ``--device`` stands where the reference
has ``--platform`` (default: the card; ``cpu`` for a replica without
one).  ``infer bench`` runs the engine's offline ``benchmark`` or, with
``--serving``, ``benchmark_serving``, and prints one JSON line of the
reference's metric keys (``spec_*`` counters under ``--draft-len``).
``--profile`` picks a preset operating point; a flag given explicitly
wins over its preset.
"""
import argparse
import json
import sys
from typing import Any, Dict, List, Optional

# Preset operating points.  latency: a 16-step decode window with the
# queue-aware adaptive window (full windows while nothing waits, 2-step
# ones while an arrival is queued with a free slot) and the lookahead
# dispatch, at 32 slots; throughput: the widest window and batch.
_INFER_PROFILES = {
    'latency': {'num_slots': 32, 'decode_steps': 16,
                'prefills_per_gap': 2, 'adaptive_window': True,
                'decode_lookahead': True},
    'throughput': {'num_slots': 48, 'decode_steps': 32,
                   'prefills_per_gap': 4},
}

# The knobs a profile sets, with their defaults when neither the user nor
# the profile gives them.  Their argparse defaults are None, so a value
# given on the command line is told apart from a default.
_KNOB_DEFAULTS = {'num_slots': 8, 'decode_steps': 8, 'prefills_per_gap': 4,
                  'adaptive_window': False, 'decode_lookahead': False}


def _apply_infer_profile(profile: Optional[str],
                         values: Dict[str, Any]) -> Dict[str, Any]:
    """Profile presets fill any knob the user did NOT set explicitly
    (None here); the rest take their defaults."""
    preset = _INFER_PROFILES[profile] if profile else {}
    return {key: (value if value is not None
                  else preset.get(key, _KNOB_DEFAULTS[key]))
            for key, value in values.items()}


def _knobs(args: argparse.Namespace) -> Dict[str, Any]:
    return _apply_infer_profile(args.profile, {
        key: getattr(args, key) for key in _KNOB_DEFAULTS})


def _add_knobs(p: argparse.ArgumentParser) -> None:
    p.add_argument('--num-slots', type=int, default=None,
                   help='concurrent decode slots (continuous batching '
                        'width; default 8)')
    p.add_argument('--decode-steps', type=int, default=None,
                   help='decode tokens per device dispatch (latency '
                        'knob; default 8)')
    p.add_argument('--prefills-per-gap', type=int, default=None,
                   help='max prefills between decode windows '
                        '(latency/throughput knob; default 4)')
    p.add_argument('--profile', default=None,
                   choices=sorted(_INFER_PROFILES),
                   help='preset operating point; explicit flags win over '
                        'the preset')
    p.add_argument('--adaptive-window', default=None,
                   action=argparse.BooleanOptionalAction,
                   help='queue-aware decode windows: full decode_steps '
                        'while nothing is waiting, short 2-step '
                        'dispatches only while an arrival is queued with '
                        'a free slot.  On under --profile latency')
    p.add_argument('--decode-lookahead', default=None,
                   action=argparse.BooleanOptionalAction,
                   help='dispatch the next decode window before reading '
                        'the current one.  On under --profile latency')
    p.add_argument('--draft-len', type=int, default=0,
                   help='speculative decoding: prompt-lookup draft tokens '
                        'verified per dispatch (0 disables); infer bench '
                        'adds the spec_* acceptance counters')
    p.add_argument('--ngram-max', type=int, default=4,
                   help='longest n-gram tried when drafting (--draft-len)')
    p.add_argument('--cache-dtype', default='bfloat16',
                   choices=['bfloat16', 'fp8'],
                   help='KV-cache storage dtype; fp8 (e4m3) halves the '
                        'cache bytes per slot')
    p.add_argument('--weight-dtype', default='bf16', choices=['bf16', 'int8'],
                   help='weight storage; int8 quantizes the decoder '
                        "projections per output channel (the llama "
                        "family's only)")
    p.add_argument('--device', default=None, choices=['cpu', 'cuda'],
                   help='the engine\'s device (default: the card)')


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog='python -m skypilot_tpu_torch.cli')
    groups = ap.add_subparsers(dest='group', required=True)
    infer = groups.add_parser(
        'infer', help='run the built-in inference engine')
    cmds = infer.add_subparsers(dest='command', required=True)

    serve = cmds.add_parser('serve',
                            help='start the HTTP inference server')
    serve.add_argument('--model', default='llama-1b',
                       help='registered model name')
    serve.add_argument('--port', type=int, default=8100)
    serve.add_argument('--host', default='0.0.0.0')
    serve.add_argument('--max-cache-len', type=int, default=2048)
    serve.add_argument('--tokenizer', default=None,
                       help='HF tokenizer (optional)')
    serve.add_argument('--eos-id', type=int, default=None,
                       help="stop token (defaults to the tokenizer's EOS)")
    serve.add_argument('--hf-model', default=None,
                       help='transformers checkpoint directory of a causal '
                            'LM: serve its weights; implies its tokenizer')
    serve.add_argument('--tensor-parallel', type=int, default=0,
                       help='shard the model over N local cards')
    serve.add_argument('--max-ttft', type=float, default=None,
                       help='admission bound (s): shed requests (HTTP 429 '
                            '+ Retry-After) while recent observed TTFT '
                            'exceeds it.  Default: off')
    serve.add_argument('--max-queue', type=int, default=None,
                       help='hard first-token backlog cap: shed (429) the '
                            'moment this many requests are queued ahead.  '
                            'Default: off')
    serve.add_argument('--max-prefixes', type=int, default=16,
                       help='resident prefix-KV entries for POST '
                            '/cache_prefix (LRU; 0 disables)')
    serve.add_argument('--lora-rank', type=int, default=0,
                       help='multi-LoRA serving: stacked rank-R adapters '
                            '(POST /load_adapter to register; 0 disables)')
    serve.add_argument('--lora-max-adapters', type=int, default=8,
                       help='resident adapter slots (--lora-rank)')
    serve.add_argument('--adapter-dir', default=None,
                       help='directory POST /load_adapter may read '
                            'adapters from (unset: loading is disabled)')
    serve.add_argument('--auto-prefix', action='store_true',
                       help='automatic prefix caching: a prompt head seen '
                            'twice registers itself as a resident prefix')
    serve.add_argument('--qos', action='store_true',
                       help='QoS admission: per-tenant weighted-fair '
                            'queueing, interactive ahead of batch with '
                            'chunk-boundary preemption, deadline shedding')
    serve.add_argument('--qos-tenant-weights', default=None,
                       help='WFQ tenant weights, e.g. "teamA=3,teamB=1" '
                            '(needs --qos)')
    _add_knobs(serve)

    bench = cmds.add_parser(
        'bench', help='benchmark the engine (req/s, tok/s, TTFT) with '
                      'synthetic prompts')
    bench.add_argument('--model', default='llama-1b')
    bench.add_argument('--num-requests', type=int, default=32)
    bench.add_argument('--prompt-len', type=int, default=128)
    bench.add_argument('--new-tokens', type=int, default=64)
    bench.add_argument('--max-cache-len', type=int, default=2048)
    bench.add_argument('--serving', action='store_true',
                       help='serving mode: requests arrive over time into '
                            'the continuous-batching loop; TTFT/TPOT are '
                            'under-load latencies (vs offline batch)')
    bench.add_argument('--qps', type=float, default=None,
                       help='Poisson arrival rate for --serving (default: '
                            'all at once)')
    _add_knobs(bench)
    return ap


def infer_serve(args: argparse.Namespace) -> None:
    """Start the HTTP inference server on this host."""
    from skypilot_tpu_torch.infer import server as infer_server
    knobs = _knobs(args)
    print(f'serving {args.hf_model or args.model} on '
          f'{args.host}:{args.port}', flush=True)
    infer_server.run(model=args.model, host=args.host, port=args.port,
                     num_slots=knobs['num_slots'],
                     max_cache_len=args.max_cache_len,
                     tokenizer_name=args.tokenizer, eos_id=args.eos_id,
                     decode_steps=knobs['decode_steps'],
                     hf_model=args.hf_model, cache_dtype=args.cache_dtype,
                     tensor_parallel=args.tensor_parallel,
                     weight_dtype=args.weight_dtype,
                     prefills_per_gap=knobs['prefills_per_gap'],
                     device=args.device, max_ttft=args.max_ttft,
                     max_queue=args.max_queue, draft_len=args.draft_len,
                     ngram_max=args.ngram_max,
                     max_prefixes=args.max_prefixes,
                     lora_rank=args.lora_rank,
                     lora_max_adapters=args.lora_max_adapters,
                     adapter_dir=args.adapter_dir,
                     adaptive_window=knobs['adaptive_window'],
                     decode_lookahead=knobs['decode_lookahead'],
                     auto_prefix=args.auto_prefix, qos=args.qos,
                     qos_tenant_weights=args.qos_tenant_weights)


def infer_bench(args: argparse.Namespace) -> Dict[str, Any]:
    """Benchmark the engine with synthetic prompts; prints and returns
    the metrics."""
    from skypilot_tpu_torch.infer.engine import (InferConfig,
                                                 InferenceEngine,
                                                 resolve_cache_dtype)
    from skypilot_tpu_torch.infer.server import _int8_config
    from skypilot_tpu_torch.models.registry import get_model_config
    knobs = _knobs(args)
    cfg = InferConfig(model=args.model, num_slots=knobs['num_slots'],
                      max_cache_len=args.max_cache_len,
                      decode_steps=knobs['decode_steps'],
                      prefills_per_gap=knobs['prefills_per_gap'],
                      cache_dtype=resolve_cache_dtype(args.cache_dtype),
                      draft_len=args.draft_len, ngram_max=args.ngram_max,
                      adaptive_decode_window=knobs['adaptive_window'],
                      decode_lookahead=knobs['decode_lookahead'])
    model_config = get_model_config(args.model)
    if args.weight_dtype != 'bf16':
        model_config = _int8_config(model_config)
    engine = InferenceEngine(model_config, cfg, device=args.device)
    if args.serving:
        metrics = engine.benchmark_serving(
            num_requests=args.num_requests, prompt_len=args.prompt_len,
            new_tokens=args.new_tokens, qps=args.qps)
    else:
        metrics = engine.benchmark(num_requests=args.num_requests,
                                   prompt_len=args.prompt_len,
                                   new_tokens=args.new_tokens)
    if args.draft_len:
        metrics.update({f'spec_{k}': v
                        for k, v in engine.spec_stats.items()})
    print(json.dumps(metrics), flush=True)
    return metrics


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == 'serve':
        infer_serve(args)
    else:
        infer_bench(args)
    return 0


if __name__ == '__main__':
    sys.exit(main())
