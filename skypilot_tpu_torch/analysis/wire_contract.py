"""WIRE pass: the port's JSON wire contract with the unchanged serve
plane (the twin of ``skypilot_tpu/analysis/wire_contract.py``).

The port's replicas sit behind the JAX package's load balancer and
routing policies, which read string-keyed JSON documents the port's
server and engine produce: nothing but convention keeps them aligned.
This pass extracts, per *surface* (one named JSON document), the keys
every producer in the port emits (via the dict-key lattice in
``analysis.dataflow``) and the keys every registered consumer reads —
the LB and its policies read as SOURCE TEXT from
``skypilot_tpu/serve/`` (never imported), the port's server, tests and
twin scripts — then reports:

- **WIRE001** (error tier): a consumed key no producer emits — or one
  emitted only on *some* producer branch (e.g. paged-only engine stats
  keys read by a consumer that may face a dense replica) — or one the
  JAX replica's producer of the same surface (its *twin*, read as
  text) emits on every branch and the port's does not: a mixed fleet
  behind one LB must see one schema.  These are the live drift bugs.
- **WIRE002** (baseline tier): a produced key nothing consumes.  Most
  are legitimate operator/dashboard surface — annotate the producing
  line ``# wire-ok: <reason>`` to declare that on the record (the
  reason is mandatory prose, reviewed like code) instead of carrying
  the finding in ``skycheck_torch_baseline.txt`` forever; unannotated
  new orphans still surface.
- **WIRE003** (error tier): one key produced with conflicting concrete
  value types across branches/producers of the same surface.

The surface registry below is explicit, like jit_boundary.HOT_ROOTS.
The serve plane's own documents (``/lb/stats``, ``/controller/state``,
the batch plane's, ``lb_sync``) have no producer in the port and are
the JAX pass's alone.

The pass is tree-scoped (``check_tree``): it needs producer and
consumer files together; ``CONSUMER_TEXT_FILES`` lists the JAX
package's files the driver reads as text for it.  ``contract()``
returns the full produced/consumed table.
"""
import ast
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.analysis import dataflow
from skypilot_tpu_torch.analysis.findings import Finding

PASS_CONSUMED_NOT_PRODUCED = 'WIRE001'
PASS_PRODUCED_NOT_CONSUMED = 'WIRE002'
PASS_TYPE_CONFLICT = 'WIRE003'

# `# wire-ok: <reason>` on a producing line: the key is deliberately
# operator/dashboard-only surface — suppress its WIRE002 orphan
# finding at the declaration site.
_WIRE_OK_RE = re.compile(r'#\s*wire-ok\b')


def _wire_ok(files: Dict[str, str], path: str, line: int) -> bool:
    text = files.get(path)
    if text is None:
        return False
    lines = text.splitlines()
    return 0 < line <= len(lines) and \
        bool(_WIRE_OK_RE.search(lines[line - 1]))


@dataclasses.dataclass(frozen=True)
class Producer:
    path: str                  # repo-relative producer file
    func: str                  # qualname (suffix ok) of the producer
    mode: Tuple[str, ...]      # dataflow.dict_key_model mode


@dataclasses.dataclass(frozen=True)
class Consumer:
    path: str
    func: str
    vars: Optional[Tuple[str, ...]] = None   # doc receivers; None=any
    exclude_vars: Tuple[str, ...] = ()       # receivers to skip


@dataclasses.dataclass(frozen=True)
class SurfaceSpec:
    name: str
    producers: Tuple[Producer, ...]
    consumers: Tuple[Consumer, ...]
    # Event streams (SSE) carry a UNION of event types: consumers
    # dispatch on discriminator keys, so branch-dependent production is
    # the design, not drift — only consumed-never-produced is an error.
    union_producers: bool = False
    # The JAX package's producer of the same surface, read as text: a
    # mixed fleet behind one LB must see one schema, so every key the
    # twin produces on every branch (an event stream: on any) is
    # consumed, and a port producer that drops one is WIRE001 at the
    # port's producer.
    twin: Optional[Producer] = None


_SERVER = 'skypilot_tpu_torch/infer/server.py'
_ENGINE = 'skypilot_tpu_torch/infer/engine.py'
_LB = 'skypilot_tpu/serve/load_balancer.py'
_POLICIES = 'skypilot_tpu/serve/load_balancing_policies.py'
_JAX_SERVER = 'skypilot_tpu/infer/server.py'
_JAX_ENGINE = 'skypilot_tpu/infer/engine.py'

# The JAX package's files this pass reads as text (never imported): the
# serve plane's consumers and the twin producers.
CONSUMER_TEXT_FILES = (_LB, _POLICIES, _JAX_SERVER, _JAX_ENGINE)

# The wire contract between the port's replicas and the serve plane.
# Producer modes: ('return',) = returned dict, ('var', N) = dict bound
# to local N (+ its N[k]= mutations), ('call', F) = first arg of every
# F(...) call in the function.
SURFACES: Tuple[SurfaceSpec, ...] = (
    # Engine-plane /stats HTTP document (server.py builds it inline in
    # the route handler around engine.stats()).
    SurfaceSpec(
        '/stats',
        producers=(Producer(_SERVER, 'do_GET', ('route-stats',)),),
        twin=Producer(_JAX_SERVER, 'do_GET', ('route-stats',)),
        consumers=(
            Consumer('tests/test_torch_qos.py',
                     'test_qos_server_matches_the_jax_server',
                     vars=('stats',)),
        ),
    ),
    # Engine-plane /healthz readiness document: the LB probe thread and
    # the routing policies read it on the routing-critical path.
    SurfaceSpec(
        '/healthz',
        producers=(Producer(_SERVER, 'health', ('var', 'doc')),),
        twin=Producer(_JAX_SERVER, 'health', ('var', 'doc')),
        consumers=(
            Consumer(_LB, '_probe_replica_once', vars=('doc',)),
            Consumer(_POLICIES, 'PrefixAffinityPolicy.observe_replica',
                     vars=('health_doc',)),
            Consumer(_SERVER, 'do_GET', vars=('doc',)),
        ),
    ),
    # The kv sub-document of /healthz (engine.kv_health()): consumed by
    # prefix-affinity routing (block_size keys the ring, occupancy
    # feeds the load penalty) and the LB probe (kv.tp).
    SurfaceSpec(
        '/healthz.kv',
        producers=(Producer(_ENGINE, 'kv_health', ('return',)),),
        twin=Producer(_JAX_ENGINE, 'kv_health', ('return',)),
        consumers=(
            Consumer(_POLICIES, 'PrefixAffinityPolicy.observe_replica',
                     vars=('kv',)),
            Consumer(_POLICIES, 'PrefixAffinityPolicy._eff_load',
                     vars=None),
            Consumer(_POLICIES, 'PrefixAffinityPolicy._load_bound',
                     vars=None, exclude_vars=('radix',)),
            Consumer(_LB, '_probe_replica_once', vars=('kv',)),
            Consumer('scripts/chaos_smoke_torch.py', None, vars=('kv',)),
        ),
    ),
    # The host_tier sub-document of /healthz.kv (and /stats['kv']): one
    # producer serves the enabled and disabled branches with the same
    # key set.
    SurfaceSpec(
        '/healthz.kv.host_tier',
        producers=(Producer(_ENGINE, '_host_tier_section',
                            ('return',)),),
        twin=Producer(_JAX_ENGINE, '_host_tier_section', ('return',)),
        consumers=(
            Consumer(_LB, '_probe_replica_once', vars=('ht',)),
            Consumer(_LB, 'lb_stats', vars=('ht',)),
        ),
    ),
    # The radix sub-document of /healthz.kv: the affinity load bound
    # boosts its spill threshold by the fleet-average hit rate.
    SurfaceSpec(
        '/healthz.kv.radix',
        producers=(Producer(_ENGINE, 'kv_health', ('var', 'radix')),),
        twin=Producer(_JAX_ENGINE, 'kv_health', ('var', 'radix')),
        consumers=(
            Consumer(_POLICIES, 'PrefixAffinityPolicy._load_bound',
                     vars=('radix',)),
        ),
    ),
    # Engine-plane /generate SSE terminal events (done/error): consumed
    # by the LB's stream relay for failover stitching.
    SurfaceSpec(
        'sse.events',
        twin=Producer(_JAX_SERVER, '_stream', ('call', 'emit')),
        producers=(
            Producer(_SERVER, '_stream', ('call', 'emit')),
            Producer(_LB, 'emit_error_event', ('call', 'emit_event')),
            Producer(_LB, '_handle_stream_generate',
                     ('call', 'emit_event')),
        ),
        consumers=(
            Consumer(_LB, '_proxy_stream_once', vars=('obj',)),
        ),
        union_producers=True,
    ),
    # engine.stats() itself (the dict under /stats['kv_cache'] and the
    # flat alias tier): branch stability matters because dashboards
    # read it for BOTH layouts.
    SurfaceSpec(
        'engine.stats',
        producers=(Producer(_ENGINE, 'stats', ('return',)),),
        twin=Producer(_JAX_ENGINE, 'stats', ('return',)),
        consumers=(
            Consumer(_SERVER, 'do_GET', vars=('st',)),
        ),
    ),
)


def _producer_model(files: Dict[str, str], spec: Producer
                    ) -> Optional[dataflow.KeyModel]:
    text = files.get(spec.path)
    if text is None:
        return None
    try:
        index = _index_for(spec.path, text)
    except SyntaxError:
        return None
    if spec.mode == ('route-stats',):
        return _route_stats_model(index)
    fn = index.find(spec.func)
    if fn is None:
        return None
    return dataflow.dict_key_model(index, fn, spec.mode)


def _route_stats_model(index: dataflow.ModuleIndex
                       ) -> Optional[dataflow.KeyModel]:
    """The dict literal server.do_GET answers on the '/stats' route —
    anchored on the route string, so handler refactors don't lose it."""
    fn = index.find('do_GET')
    if fn is None:
        return None
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.If):
            continue
        test = node.test
        if isinstance(test, ast.Compare) and test.comparators and \
                isinstance(test.comparators[0], ast.Constant) and \
                test.comparators[0].value == '/stats':
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == '_json' and \
                        len(sub.args) >= 2 and \
                        isinstance(sub.args[1], ast.Dict):
                    model = dataflow.KeyModel()
                    dataflow._literal_keys(index, fn, sub.args[1],
                                           model, conditional=False)
                    return model
    return None


_INDEX_CACHE: Dict[Tuple[str, int], dataflow.ModuleIndex] = {}


def _index_for(path: str, text: str) -> dataflow.ModuleIndex:
    key = (path, hash(text))
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        if len(_INDEX_CACHE) > 64:   # bound memory across test runs
            _INDEX_CACHE.clear()
        idx = dataflow.ModuleIndex(path, text)
        _INDEX_CACHE[key] = idx
    return idx


def _consumer_keys(files: Dict[str, str], spec: Consumer
                   ) -> Dict[str, Tuple[int, str]]:
    """key -> (line, 'path:func') over one consumer spec."""
    text = files.get(spec.path)
    if text is None:
        return {}
    try:
        index = dataflow.ModuleIndex(spec.path, text)
    except SyntaxError:
        return {}
    fns: List[dataflow.FunctionInfo] = []
    if spec.func is None:
        fns = list(index.functions.values())
    else:
        fn = index.find(spec.func)
        if fn is not None:
            fns = [fn]
    out: Dict[str, Tuple[int, str]] = {}
    for fn in fns:
        for key, line in dataflow.read_keys(
                index, fn, spec.vars,
                exclude_vars=spec.exclude_vars).items():
            out.setdefault(key, (line, f'{spec.path}:{fn.qualname}'))
    return out


@dataclasses.dataclass
class SurfaceContract:
    name: str
    produced: dataflow.KeyModel
    consumed: Dict[str, Tuple[int, str]]
    producer_of: Dict[str, Tuple[str, int]]   # key -> (path, line)
    producer_path: str
    union_producers: bool = False
    # Keys the JAX twin producer emits on every branch -> its line.
    twin_keys: Dict[str, int] = dataclasses.field(default_factory=dict)
    twin_where: str = ''


def contract(files: Dict[str, str],
             surfaces: Sequence[SurfaceSpec] = SURFACES
             ) -> List[SurfaceContract]:
    out: List[SurfaceContract] = []
    for spec in surfaces:
        produced: Optional[dataflow.KeyModel] = None
        producer_path = spec.producers[0].path
        producer_of: Dict[str, Tuple[str, int]] = {}
        for p in spec.producers:
            model = _producer_model(files, p)
            if model is None:
                continue
            for key, line in model.lines.items():
                producer_of.setdefault(key, (p.path, line))
            if produced is None:
                produced = model
            else:
                # Multiple producers of one surface are alternatives
                # (e.g. engine done event vs LB synthesized terminal):
                # 'always' means every producer emits it.
                produced.merge_branch(model)
        if produced is None:
            produced = dataflow.KeyModel(complete=False)
        consumed: Dict[str, Tuple[int, str]] = {}
        for c in spec.consumers:
            for key, loc in _consumer_keys(files, c).items():
                consumed.setdefault(key, loc)
        twin_keys: Dict[str, int] = {}
        twin_where = ''
        if spec.twin is not None:
            model = _producer_model(files, spec.twin)
            if model is not None:
                # An event stream's union: every key some event carries.
                keys = (model.keys if spec.union_producers
                        else model.always)
                twin_keys = {k: model.lines.get(k, 1) for k in keys}
                twin_where = f'{spec.twin.path}:{spec.twin.func}'
        out.append(SurfaceContract(spec.name, produced, consumed,
                                   producer_of, producer_path,
                                   spec.union_producers, twin_keys,
                                   twin_where))
    return out


def check_tree(files: Dict[str, str],
               surfaces: Sequence[SurfaceSpec] = SURFACES
               ) -> List[Finding]:
    findings: List[Finding] = []
    for sc in contract(files, surfaces):
        prod = sc.produced
        for key, (line, where) in sorted(sc.consumed.items()):
            path, _, func = where.partition(':')
            if key not in prod.keys:
                if not prod.complete:
                    # The producer model has unresolved spreads: a
                    # missing key is unprovable — stay quiet rather
                    # than cry wolf on every consumer.
                    continue
                findings.append(Finding(
                    path, line, PASS_CONSUMED_NOT_PRODUCED,
                    f"surface '{sc.name}': key '{key}' consumed by "
                    f'{func} but never produced'))
            elif key in prod.sometimes and not sc.union_producers:
                findings.append(Finding(
                    path, line, PASS_CONSUMED_NOT_PRODUCED,
                    f"surface '{sc.name}': key '{key}' consumed by "
                    f'{func} but produced only on some branches '
                    '(layout/feature-dependent producers must emit a '
                    'stable key set)'))
        for key in sorted(sc.twin_keys):
            if key in prod.keys and (key in prod.always or
                                     sc.union_producers):
                continue
            if key not in prod.keys and not prod.complete:
                continue
            findings.append(Finding(
                sc.producer_path, _producer_line(sc),
                PASS_CONSUMED_NOT_PRODUCED,
                f"surface '{sc.name}': key '{key}' produced by the JAX "
                f'replica ({sc.twin_where}) but '
                + ('never by the port' if key not in prod.keys
                   else 'only on some branches by the port')
                + ' (a mixed fleet behind one LB must see one schema)'))
        for key in sorted(prod.keys):
            if key not in sc.consumed and key not in sc.twin_keys:
                ppath, pline = sc.producer_of.get(
                    key, (sc.producer_path, 1))
                if _wire_ok(files, ppath, pline):
                    continue
                findings.append(Finding(
                    ppath, pline, PASS_PRODUCED_NOT_CONSUMED,
                    f"surface '{sc.name}': key '{key}' produced but "
                    'no registered consumer reads it'))
        for key, types in sorted(prod.types.items()):
            concrete = types - {'unknown', 'none'}
            if len(concrete) > 1:
                ppath, pline = sc.producer_of.get(
                    key, (sc.producer_path, 1))
                findings.append(Finding(
                    ppath, pline, PASS_TYPE_CONFLICT,
                    f"surface '{sc.name}': key '{key}' produced with "
                    f'conflicting value types '
                    f'{"/".join(sorted(concrete))}'))
    return findings


def _producer_line(sc: SurfaceContract) -> int:
    """The first key line of the port's producer (where a key the twin
    has and the port lacks is reported)."""
    lines = [ln for path, ln in sc.producer_of.values()
             if path == sc.producer_path]
    return min(lines) if lines else 1
