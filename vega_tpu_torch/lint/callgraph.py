"""vegalint v3: project-wide call graph + thread-role dataflow.

The engine is a multi-tenant service with a dozen distinct thread roles
(per-job DAG event loops, the task arbiter, the elastic controller, the
liveness reaper, fetch producer lanes, streaming receivers, the batch
driver, worker task threads), and the worst recent bug classes —
reaper-tick read races, event-loop stalls that skew straggler medians,
closures capturing driver-only state that only explode at pickle time —
are REACHABILITY bugs that per-file AST rules (VG002–VG015) structurally
cannot see. This module is the interprocedural layer:

* a per-file **extraction** (:func:`extract_callgraph`, cached in the
  engine's mtime-keyed ``FileRecord`` store exactly like the VG009–VG012
  contract index) reduces each file to def/call/closure/spawn facts;
* a global **combine** (:func:`build_graph`) joins them into a call
  graph — module functions, methods resolved through ``self`` and the
  single-inheritance class index, ``module.fn`` attribute chains through
  the import-alias map, and a guarded unique-name fallback for
  ``obj.method()`` receivers the AST cannot type;
* :func:`propagate_roles` seeds the graph with the DECLARED role map
  (:data:`ROLES`) and floods roles along call and callback edges.

Role propagation deliberately does NOT cross thread-spawn boundaries
(``threading.Thread(target=...)``, ``pool.submit``): offloading work to
a fresh thread is this codebase's idiom for *escaping* a latency-critical
role (the reaper hands a dead host's ssh kill to its own thread precisely
so liveness detection never blocks on it), so a spawn edge changes role
rather than inheriting it. Spawn targets get roles only via :data:`ROLES`.

Known limits: dynamic dispatch through containers
of callables, `getattr` calls, and receivers typed only at runtime are
invisible; the unique-method-name fallback refuses common names
(``run``/``get``/``submit``/...) so one generic name cannot weld the
whole graph together. The runtime half (sync_witness role recording
under ``VEGA_TPU_DEBUG_SYNC=1``) cross-checks this static map against
observed thread identities.

Pure stdlib, same contract as engine.py: never imports torch or any
vega_tpu_torch runtime module. sync_witness lazily imports THIS module for
the role table, so keep it import-light. The role map names the port's
functions; every role of vega_tpu's map has its counterpart here.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from vega_tpu_torch.lint.engine import FileCtx, Finding

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

# --------------------------------------------------------------------------
# The declared role map — THE single source of truth, shared by the static
# rules (VG016/VG019) and the runtime witness (sync_witness.note_thread_role
# checks observed thread names against `thread_prefixes`).
# --------------------------------------------------------------------------
# critical: latency-sensitive control loop — a blocking op reachable from
#   it stalls scheduling/liveness for every tenant (VG016).
# confined: executor-/ingest-side — driver-only functions must not be
#   reachable from it (VG019).
ROLES: Dict[str, dict] = {
    "dag-loop": {
        "entries": (
            "vega_tpu_torch.scheduler.jobserver.JobServer._drive",
            "vega_tpu_torch.scheduler.dag.DAGScheduler._run_job_inner",
        ),
        "thread_prefixes": ("vega-job-",),
        "critical": True,
        "confined": False,
        "doc": "per-job DAG event loop (JobServer._drive thread)",
    },
    "arbiter": {
        # Not a thread of its own: arbiter methods run inline on job-loop
        # and task-callback threads, which is exactly why they must never
        # block (every pool's admission goes through them).
        "entries": (
            "vega_tpu_torch.scheduler.jobserver.TaskArbiter.submit",
            "vega_tpu_torch.scheduler.jobserver.TaskArbiter._pump",
            "vega_tpu_torch.scheduler.jobserver.TaskArbiter._release",
        ),
        "thread_prefixes": (),
        "critical": True,
        "confined": False,
        "doc": "task arbiter (runs inline on job/callback threads)",
    },
    "elastic": {
        "entries": ("vega_tpu_torch.scheduler.elastic.ElasticController._loop",),
        "thread_prefixes": ("elastic-controller",),
        "critical": True,
        "confined": False,
        "doc": "elastic controller tick",
    },
    "reaper": {
        "entries": (
            "vega_tpu_torch.distributed.backend.DistributedBackend._reaper_loop",
        ),
        "thread_prefixes": ("executor-reaper",),
        "critical": True,
        "confined": False,
        "doc": "executor liveness reaper",
    },
    "fetch-producer": {
        "entries": (
            "vega_tpu_torch.shuffle.fetcher.ShuffleFetcher._stream.produce",
        ),
        "thread_prefixes": ("shuffle-fetch",),
        "critical": False,
        "confined": False,
        "doc": "shuffle fetch producer lane",
    },
    "stream-receiver": {
        "entries": ("vega_tpu_torch.streaming.source.Receiver._run",),
        "thread_prefixes": ("stream-recv-",),
        "critical": False,
        "confined": True,
        "doc": "streaming ingest receiver",
    },
    "batch-driver": {
        "entries": ("vega_tpu_torch.streaming.context.StreamingContext._loop",),
        "thread_prefixes": ("stream-batches",),
        "critical": False,
        "confined": False,
        "doc": "micro-batch driver loop",
    },
    "worker-task": {
        # socketserver.ThreadingMixIn names handler threads generically,
        # so there is no name prefix to cross-check — the role is noted
        # explicitly at the top of _TaskHandler.handle.
        "entries": ("vega_tpu_torch.distributed.worker._TaskHandler.handle",),
        "thread_prefixes": (),
        "critical": False,
        "confined": True,
        "doc": "executor task-serving thread",
    },
    "listener-bus": {
        "entries": (
            "vega_tpu_torch.scheduler.events.LiveListenerBus._dispatch_loop",),
        "thread_prefixes": ("listener-bus",),
        "critical": False,
        "confined": False,
        "doc": "event listener dispatch loop",
    },
    "driver-api": {
        # The implicit default: user code on the main thread. Declared for
        # completeness/docs; nothing propagates from it.
        "entries": (),
        "thread_prefixes": (),
        "critical": False,
        "confined": False,
        "doc": "driver API (any un-noted thread, usually main)",
    },
}

CRITICAL_ROLES = tuple(r for r, s in ROLES.items() if s["critical"])
CONFINED_ROLES = tuple(r for r, s in ROLES.items() if s["confined"])

# Driver-only seed set for VG019 (beyond `# vegalint: role[driver-only]`
# annotations): Env teardown, driver mesh/context teardown, fleet
# mutation. The port has one Env per Context and no process singleton to
# reset: its counterpart of vega_tpu's `Env.reset` is `Env.close`, which
# tears down the shuffle store and the cache under every concurrent task.
# An executor's Env is built and closed by its worker's main thread —
# that is fine; VG019 constrains reachability from the confined roles
# (task threads, receivers), not from main.
DRIVER_ONLY_SEEDS = (
    "vega_tpu_torch.env.Env.close",
    "vega_tpu_torch.context.Context.stop",
    "vega_tpu_torch.distributed.backend.DistributedBackend.add_executor",
    "vega_tpu_torch.distributed.backend.DistributedBackend.remove_executor",
    "vega_tpu_torch.scheduler.elastic.ElasticController.decommission",
)

_ROLE_COMMENT_RE = re.compile(r"#\s*vegalint:\s*role\[([a-z0-9_,\- ]+)\]")

# Unique-method-name fallback refuses these: one generic name must not
# weld unrelated subsystems into a single role blob.
_COMMON_METHOD_NAMES = frozenset({
    "run", "start", "stop", "get", "put", "set", "close", "submit",
    "send", "recv", "join", "wait", "result", "acquire", "release",
    "append", "add", "pop", "clear", "update", "read", "write", "open",
    "items", "keys", "values", "copy", "flush", "next", "handle",
    "count", "reduce", "collect", "map", "filter", "post", "emit",
    "name", "main", "connect", "shutdown", "cancel", "done", "fetch",
    "compute", "iterator", "serve", "dispatch", "encode", "decode",
    "load", "dump", "dumps", "loads", "register", "unregister",
})

# RDD-surface methods whose function argument is pickled and shipped to
# executors (VG017).
_SHIP_METHODS = frozenset({
    "map", "filter", "flat_map", "map_partitions",
    "map_partitions_with_index", "map_values", "flat_map_values",
    "key_by", "foreach", "foreach_partition", "reduce_by_key",
    "combine_by_key", "aggregate", "aggregate_by_key", "fold",
    "fold_by_key", "sort_by", "group_by", "starmap", "tree_aggregate",
})

# Classes whose instances are driver-resident control-plane state: a
# closure capturing `self` (or a binding constructed from them) must not
# ship to executors.
_DRIVER_ONLY_CLASSES = frozenset({
    "Context", "StreamingContext", "DAGScheduler", "JobServer",
    "TaskArbiter", "ElasticController", "DistributedBackend",
    "DriverService", "Env", "LiveListenerBus",
})

# Attribute names whose read is a driver control-plane handle.
_DRIVER_HANDLE_ATTRS = frozenset({
    "context", "scheduler", "_scheduler", "dag_scheduler", "backend",
    "_backend", "job_server", "_job_server",
})


def _last_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _kw(call: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in call.keywords)


def _own_nodes(root: ast.AST) -> Iterator[ast.AST]:
    """Descendants excluding nested def/lambda subtrees (they run later,
    possibly on a different thread)."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNC_DEFS + (ast.Lambda,)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# --------------------------------------------------------------------------
# Blocking-operation classifier (VG016). Raw socket recv() is deliberately
# NOT listed: recv boundedness is socket-state-dependent and VG012 already
# polices raw recvs lexically in the cross-process dirs; here we flag the
# shapes that are unbounded regardless of state.
# --------------------------------------------------------------------------
def _blocking_site(call: ast.Call, ctx: FileCtx) -> Optional[str]:
    name = _last_name(call.func)
    if name in ("device_get", "host_get"):
        # Only the LEAF transfer: a call resolving into the project
        # (mesh.host_get) is followed by the graph, and the transfer
        # inside it is flagged once, where it lives — flagging every
        # transitive caller would bury the signal.
        qual = ctx.qualified(call.func) or ""
        if not qual.startswith("vega_tpu_torch."):
            return f"{name}() — a driver<->device round trip"
    if name == "cpu" and isinstance(call.func, ast.Attribute) \
            and not call.args and not call.keywords:
        return ".cpu() — a driver<->device round trip"
    if (ctx.qualified(call.func) or "") == "torch.cuda.synchronize":
        return "torch.cuda.synchronize() — waits for every queued kernel"
    if name == "settimeout" and len(call.args) == 1 \
            and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value is None:
        return "settimeout(None) — removes the socket deadline"
    if name == "create_connection" and not _kw(call, "timeout") \
            and len(call.args) < 2:
        return "create_connection without timeout"
    if name == "result" and not call.args and not _kw(call, "timeout") \
            and isinstance(call.func, ast.Attribute):
        return "Future.result() without timeout"
    if name == "get" and isinstance(call.func, ast.Attribute) \
            and not call.args and not _kw(call, "timeout"):
        recv = call.func.value
        rname = (recv.attr if isinstance(recv, ast.Attribute)
                 else recv.id if isinstance(recv, ast.Name) else "") or ""
        if "queue" in rname.lower() or rname in ("q", "inq", "outq"):
            return "queue get() without timeout"
    if name in ("wait", "communicate") and not call.args \
            and not _kw(call, "timeout") \
            and isinstance(call.func, ast.Attribute):
        return f"{name}() without timeout"
    if name == "join" and not call.args and not _kw(call, "timeout") \
            and isinstance(call.func, ast.Attribute) \
            and not isinstance(call.func.value, ast.Constant):
        # `t.join()` (thread) — `"sep".join(parts)` always has an arg.
        return "join() without timeout"
    qual = ctx.qualified(call.func) or ""
    if qual.startswith("subprocess.") and qual.split(".")[-1] in (
            "run", "call", "check_call", "check_output") \
            and not _kw(call, "timeout"):
        return f"{qual}() without timeout"
    return None


# --------------------------------------------------------------------------
# Per-file extraction
# --------------------------------------------------------------------------
def _role_comment_lines(ctx: FileCtx) -> Dict[int, List[str]]:
    out: Dict[int, List[str]] = {}
    for i, line in enumerate(ctx.lines, start=1):
        m = _ROLE_COMMENT_RE.search(line)
        if m:
            out[i] = [s.strip() for s in m.group(1).split(",") if s.strip()]
    return out


def _thread_target_args(call: ast.Call) -> List[ast.AST]:
    """The callable operands of a thread/pool spawn call — role
    propagation must NOT follow them."""
    name = _last_name(call.func)
    out: List[ast.AST] = []
    if name == "Thread":
        for k in call.keywords:
            if k.arg == "target":
                out.append(k.value)
    elif name in ("submit", "apply_async", "start_new_thread",
                  "run_in_executor", "defer"):
        if call.args:
            out.append(call.args[0])
    return out


def _ref_descs(node: ast.AST, ctx: FileCtx, file_funcs: Set[str],
               cls_methods: Set[str]) -> List[tuple]:
    """Descriptors for a bare function reference (callback argument)."""
    if isinstance(node, ast.Name):
        alias = ctx.aliases.get(node.id)
        if alias and alias.startswith("vega_tpu_torch."):
            return [("qual", alias)]
        if node.id in file_funcs:
            return [("name", node.id)]
    elif isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name):
        if node.value.id == "self" and node.attr in cls_methods:
            return [("self", node.attr)]
        qual = ctx.qualified(node)
        if qual and qual.startswith("vega_tpu_torch."):
            return [("qual", qual)]
    return []


def extract_callgraph(ctx: FileCtx) -> Optional[dict]:
    """Per-file facts for the project call graph (cached by the engine)."""
    if not ctx.in_dir("vega_tpu_torch"):
        return None
    role_lines = _role_comment_lines(ctx)

    funcs: Dict[str, dict] = {}
    classes: Dict[str, dict] = {}
    # Pre-pass: every function name defined anywhere in the file (for
    # callback-reference filtering) and class -> method names.
    file_funcs: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, _FUNC_DEFS):
            file_funcs.add(node.name)

    def scan_function(fn: ast.AST, qual: str, cls: Optional[str]) -> None:
        cls_methods = set(classes.get(cls, {}).get("methods", ())) \
            if cls else set()
        roles = []
        for ln in (fn.lineno, fn.lineno - 1):
            roles.extend(role_lines.get(ln, ()))
        calls: List[tuple] = []
        refs: List[tuple] = []
        spawns: List[tuple] = []
        blocking: List[tuple] = []
        skip_ref_ids: Set[int] = set()
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            for tgt in _thread_target_args(node):
                skip_ref_ids.add(id(tgt))
                spawns.extend(_ref_descs(tgt, ctx, file_funcs,
                                         cls_methods))
            b = _blocking_site(node, ctx)
            if b:
                blocking.append((b, node.lineno, node.col_offset + 1))
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "self":
                calls.append(("self", f.attr))
            elif isinstance(f, ast.Name):
                alias = ctx.aliases.get(f.id)
                if alias and alias.startswith("vega_tpu_torch."):
                    calls.append(("qual", alias))
                else:
                    calls.append(("name", f.id))
            elif isinstance(f, ast.Attribute):
                qualn = ctx.qualified(f)
                if qualn and qualn.startswith("vega_tpu_torch."):
                    calls.append(("qual", qualn))
                else:
                    calls.append(("attr", f.attr))
            for a in list(node.args) + [k.value for k in node.keywords]:
                if id(a) in skip_ref_ids:
                    continue
                refs.extend(_ref_descs(a, ctx, file_funcs, cls_methods))
        funcs[qual] = {
            "line": fn.lineno,
            "cls": cls,
            "roles": roles,
            "calls": sorted(set(calls)),
            "refs": sorted(set(refs)),
            "spawns": sorted(set(spawns)),
            "blocking": blocking,
        }
        for sub in ast.iter_child_nodes(fn):
            walk_scope(sub, qual, cls)

    def walk_scope(node: ast.AST, prefix: str,
                   cls: Optional[str]) -> None:
        if isinstance(node, _FUNC_DEFS):
            qual = f"{prefix}.{node.name}" if prefix else node.name
            scan_function(node, qual, cls)
        elif isinstance(node, ast.ClassDef):
            methods = {s.name for s in node.body
                       if isinstance(s, _FUNC_DEFS)}
            classes[node.name] = {
                "methods": sorted(methods),
                "bases": [b for b in (_last_name(x) for x in node.bases)
                          if b],
            }
            for sub in node.body:
                walk_scope(sub, node.name, node.name)
        else:
            for sub in ast.iter_child_nodes(node):
                walk_scope(sub, prefix, cls)

    for node in ctx.tree.body:
        walk_scope(node, "", None)

    if not funcs:
        return None
    return {"module": ctx.module, "funcs": funcs, "classes": classes}


# --------------------------------------------------------------------------
# Combine: graph build + role propagation
# --------------------------------------------------------------------------
class Graph:
    def __init__(self) -> None:
        self.defs: Dict[str, dict] = {}  # full qual -> info (+file)
        self.edges: Dict[str, Set[str]] = {}  # resolved call/ref edges
        self.classes: Dict[str, List[Tuple[str, dict]]] = {}  # name->defs
        self.subclasses: Dict[str, Set[str]] = {}  # name -> subclass names
        self.by_method: Dict[str, List[str]] = {}  # bare name -> quals

    def add_edge(self, src: str, dst: str) -> None:
        self.edges.setdefault(src, set()).add(dst)


def _method_quals(g: Graph, cls: str, attr: str,
                  seen: Optional[Set[str]] = None) -> List[str]:
    """Resolve a method on class `cls` (by name): own def, else base
    defs; plus overrides in every transitive subclass (role propagation
    must reach the override that actually runs)."""
    seen = seen if seen is not None else set()
    if cls in seen:
        return []
    seen.add(cls)
    out: List[str] = []
    for module, info in g.classes.get(cls, ()):
        if attr in info.get("methods", ()):
            out.append(f"{module}.{cls}.{attr}")
        else:
            for base in info.get("bases", ()):
                out.extend(_method_quals(g, base, attr, seen))
    for sub in g.subclasses.get(cls, ()):
        if sub in seen:
            continue
        for module, info in g.classes.get(sub, ()):
            if attr in info.get("methods", ()):
                out.append(f"{module}.{sub}.{attr}")
        out.extend(q for q in _method_quals(g, sub, attr, seen)
                   if q not in out)
    return out


def build_graph(records: List[Tuple[str, dict]]) -> Graph:
    g = Graph()
    for display, data in records:
        module = data["module"]
        for qual, info in data["funcs"].items():
            full = f"{module}.{qual}"
            g.defs[full] = dict(info, file=display, module=module)
            g.by_method.setdefault(qual.rsplit(".", 1)[-1],
                                   []).append(full)
        for cls, cinfo in data.get("classes", {}).items():
            g.classes.setdefault(cls, []).append((module, cinfo))
            for base in cinfo.get("bases", ()):
                g.subclasses.setdefault(base, set()).add(cls)

    for full, info in g.defs.items():
        module = info["module"]
        cls = info["cls"]
        for desc in list(info["calls"]) + list(info["refs"]):
            kind, name = desc[0], desc[1]
            if kind == "self" and cls:
                for q in _method_quals(g, cls, name):
                    g.add_edge(full, q)
            elif kind == "name":
                # Nearest enclosing scope first: nested def, then outer
                # scopes, then module level.
                parts = full.split(".")
                for depth in range(len(parts), 0, -1):
                    cand = ".".join(parts[:depth] + [name])
                    if cand in g.defs:
                        g.add_edge(full, cand)
                        break
            elif kind == "qual":
                if name in g.defs:
                    g.add_edge(full, name)
                else:
                    # `Cls.meth` via an alias: resolve through the class
                    # index (covers subclass overrides too).
                    head, _, attr = name.rpartition(".")
                    cname = head.rsplit(".", 1)[-1] if head else ""
                    if cname and cname in g.classes:
                        for q in _method_quals(g, cname, attr):
                            g.add_edge(full, q)
            elif kind == "attr":
                if name in _COMMON_METHOD_NAMES or name.startswith("__"):
                    continue
                cands = g.by_method.get(name, ())
                if len(cands) == 1:
                    g.add_edge(full, cands[0])
    return g


def propagate_roles(g: Graph) -> Tuple[Dict[str, Set[str]],
                                       Dict[Tuple[str, str], str]]:
    """Flood roles from ROLES entries along resolved edges. Returns
    (roles-per-qual, parent map keyed by (qual, role) for witness
    paths)."""
    roles: Dict[str, Set[str]] = {}
    parent: Dict[Tuple[str, str], str] = {}
    frontier: List[Tuple[str, str]] = []
    for role, spec in ROLES.items():
        for entry in spec["entries"]:
            if entry in g.defs:
                roles.setdefault(entry, set()).add(role)
                frontier.append((entry, role))
    while frontier:
        qual, role = frontier.pop()
        for nxt in g.edges.get(qual, ()):
            have = roles.setdefault(nxt, set())
            if role in have:
                continue
            have.add(role)
            parent[(nxt, role)] = qual
            frontier.append((nxt, role))
    return roles, parent


def witness_path(parent: Dict[Tuple[str, str], str], qual: str,
                 role: str) -> List[str]:
    """Entry -> ... -> qual call chain that carried `role` to `qual`."""
    path = [qual]
    seen = {qual}
    while (path[-1], role) in parent:
        prev = parent[(path[-1], role)]
        if prev in seen:
            break
        path.append(prev)
        seen.add(prev)
    return list(reversed(path))


def _short(qual: str) -> str:
    parts = qual.split(".")
    return ".".join(parts[-2:]) if len(parts) > 2 else qual


def _render_path(parent, qual: str, role: str) -> str:
    return " -> ".join(_short(q) for q in witness_path(parent, qual, role))


# --------------------------------------------------------------------------
# VG016 — blocking operations reachable from latency-critical roles
# --------------------------------------------------------------------------
def check_vg016(records: List[Tuple[str, dict]]) -> Iterator[Finding]:
    g = build_graph(records)
    roles, parent = propagate_roles(g)
    for qual, info in sorted(g.defs.items()):
        crit = sorted(r for r in roles.get(qual, ()) if r in CRITICAL_ROLES)
        if not crit or not info["blocking"]:
            continue
        role = crit[0]
        for desc, line, col in info["blocking"]:
            yield Finding(
                "VG016", info["file"], line, col,
                f"{desc}, reachable from latency-critical role "
                f"'{role}' (path: {_render_path(parent, qual, role)}) — "
                "a stall here parks scheduling/liveness for every "
                "tenant; bound the wait or offload to a spawned thread "
                "(spawn boundaries end the role)")


# --------------------------------------------------------------------------
# VG019 — role confinement: driver-only functions unreachable from
# worker/receiver roles
# --------------------------------------------------------------------------
def check_vg019(records: List[Tuple[str, dict]]) -> Iterator[Finding]:
    g = build_graph(records)
    roles, parent = propagate_roles(g)
    driver_only: Dict[str, str] = {}
    for qual in DRIVER_ONLY_SEEDS:
        if qual in g.defs:
            driver_only[qual] = "seed set"
    for qual, info in g.defs.items():
        if "driver-only" in info.get("roles", ()):
            driver_only[qual] = "role[driver-only] annotation"
    for qual, why in sorted(driver_only.items()):
        bad = sorted(r for r in roles.get(qual, ())
                     if r in CONFINED_ROLES)
        for role in bad:
            info = g.defs[qual]
            yield Finding(
                "VG019", info["file"], info["line"], 1,
                f"driver-only function '{_short(qual)}' ({why}) is "
                f"reachable from confined role '{role}' (path: "
                f"{_render_path(parent, qual, role)}) — executor/"
                "receiver threads must never mutate driver state")


# --------------------------------------------------------------------------
# VG017 — driver-only state captured into executor-shipped closures
# (self-contained per file: the capture, its binding, and the ship site
# are all in one function scope)
# --------------------------------------------------------------------------
def _driver_only_binding(expr: ast.AST, ctx: FileCtx) -> Optional[str]:
    """Why the bound value is driver-only, or None."""
    if isinstance(expr, ast.Call):
        name = _last_name(expr.func)
        qual = ctx.qualified(expr.func) or ""
        if name in _DRIVER_ONLY_CLASSES:
            return f"a {name} instance"
        if name in ("Lock", "RLock", "Condition", "named_lock"):
            return "a lock"
        if qual in ("socket.socket", "socket.create_connection") \
                or qual.endswith("protocol.connect"):
            return "a socket"
        if name == "get" and isinstance(expr.func, ast.Attribute) \
                and _last_name(expr.func.value) == "Env":
            return "the Env singleton"
        if qual.startswith("torch."):
            return "a torch tensor"
    elif isinstance(expr, ast.Attribute):
        if expr.attr in _DRIVER_HANDLE_ATTRS:
            return f"a driver handle (.{expr.attr})"
    return None


def _closure_free_loads(fn: ast.AST) -> Set[str]:
    """Names loaded inside a closure (lambda or def, including default
    arg expressions) that the closure itself does not bind."""
    bound: Set[str] = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        bound.add(a.arg)
    loads: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                loads.add(node.id)
            else:
                bound.add(node.id)
    return loads - bound


def check_vg017(ctx: FileCtx) -> Iterator[Finding]:
    if not ctx.in_dir("vega_tpu_torch"):
        return
    for outer in ast.walk(ctx.tree):
        if not isinstance(outer, _FUNC_DEFS):
            continue
        # Enclosing-scope facts: local bindings and nested defs.
        bindings: Dict[str, ast.AST] = {}
        nested: Dict[str, ast.AST] = {}
        enclosing_cls: Optional[str] = None
        for node in _own_nodes(outer):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                bindings[node.targets[0].id] = node.value
        for node in ast.iter_child_nodes(outer):
            if isinstance(node, _FUNC_DEFS):
                nested[node.name] = node
        for node in _own_nodes(outer):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SHIP_METHODS):
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                closure: Optional[ast.AST] = None
                if isinstance(arg, ast.Lambda):
                    closure = arg
                elif isinstance(arg, ast.Name) and arg.id in nested:
                    closure = nested[arg.id]
                if closure is None:
                    continue
                for var in sorted(_closure_free_loads(closure)):
                    why = None
                    if var in bindings:
                        why = _driver_only_binding(bindings[var], ctx)
                    if why is None:
                        continue
                    yield Finding(
                        "VG017", ctx.display, node.lineno,
                        node.col_offset + 1,
                        f"closure passed to .{node.func.attr}() captures "
                        f"'{var}', bound to {why} — driver-only state "
                        "shipped to executors fails at pickle time at "
                        "best, runs against a stub at worst; pass plain "
                        "data in, or compute on the driver first")


# --------------------------------------------------------------------------
# VG018 — leaked sockets/files in distributed/, shuffle/, streaming/
# --------------------------------------------------------------------------
_VG018_DIRS = (("vega_tpu_torch", "distributed"),
               ("vega_tpu_torch", "shuffle"),
               ("vega_tpu_torch", "streaming"))


def _acquisition_desc(call: ast.Call, ctx: FileCtx) -> Optional[str]:
    qual = ctx.qualified(call.func) or ""
    name = _last_name(call.func)
    if qual in ("socket.socket", "socket.create_connection"):
        return f"{name}()"
    if name == "connect" and qual.endswith("protocol.connect"):
        return "protocol.connect()"
    if isinstance(call.func, ast.Name) and call.func.id == "open" \
            and "open" not in ctx.aliases:
        return "open()"
    return None


def _scan_vg018_fn(fn: ast.AST, ctx: FileCtx) -> Iterator[Finding]:
    acquired: List[Tuple[str, str, int, int]] = []  # (var, desc, ln, col)
    for node in _own_nodes(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.value, ast.Call):
            desc = _acquisition_desc(node.value, ctx)
            if desc is None:
                continue
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                acquired.append((tgt.id, desc, node.lineno,
                                 node.col_offset + 1))
    if not acquired:
        return
    # Names released inside a `finally:` (any Try's finalbody), handed
    # to contextlib.closing, or used as a `with` context manager.
    released: Set[str] = set()
    for node in _own_nodes(fn):
        if isinstance(node, ast.Try):
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr in ("close", "shutdown") \
                            and isinstance(sub.func.value, ast.Name):
                        released.add(sub.func.value.id)
        elif isinstance(node, ast.Call) \
                and _last_name(node.func) == "closing":
            for a in node.args:
                if isinstance(a, ast.Name):
                    released.add(a.id)
        elif isinstance(node, ast.With):
            for item in node.items:
                if isinstance(item.context_expr, ast.Name):
                    released.add(item.context_expr.id)
    # Names that escape the function (ownership transfer): returned,
    # yielded, stored into an attribute/container, or passed to a call.
    escaped: Set[str] = set()
    for node in _own_nodes(fn):
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)) \
                and node.value is not None:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name):
                    escaped.add(sub.id)
        elif isinstance(node, ast.Call):
            for a in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(a, ast.Name):
                    escaped.add(a.id)
        elif isinstance(node, ast.Assign):
            tgt = node.targets[0]
            if isinstance(tgt, (ast.Attribute, ast.Subscript, ast.Tuple)) \
                    and isinstance(node.value, ast.Name):
                escaped.add(node.value.id)
    for var, desc, line, col in acquired:
        if var in released or var in escaped:
            continue
        yield Finding(
            "VG018", ctx.display, line, col,
            f"{desc} assigned to '{var}' with no `with`/try-finally "
            "release on this path — an exception between acquire and "
            "close leaks the handle (and a leaked socket holds its "
            "peer's accept slot); wrap in "
            "`with closing(...)` or close in a finally")


def check_vg018(ctx: FileCtx) -> Iterator[Finding]:
    if not any(ctx.in_dir(*d) for d in _VG018_DIRS):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, _FUNC_DEFS):
            yield from _scan_vg018_fn(node, ctx)


# --------------------------------------------------------------------------
# --explain-role support
# --------------------------------------------------------------------------
def explain(records: List[Tuple[str, dict]], needle: str) -> List[dict]:
    """Functions whose full qual ends with `needle`, each with its
    propagated roles and one witness call path per role."""
    g = build_graph(records)
    roles, parent = propagate_roles(g)
    out = []
    for qual in sorted(g.defs):
        if qual == needle or qual.endswith("." + needle):
            out.append({
                "function": qual,
                "file": g.defs[qual]["file"],
                "line": g.defs[qual]["line"],
                "roles": {r: witness_path(parent, qual, r)
                          for r in sorted(roles.get(qual, ()))},
            })
    return out
