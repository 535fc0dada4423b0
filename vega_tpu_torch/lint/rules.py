"""vegalint rules VG002–VG020 over vega_tpu_torch: the project
invariants as AST checks.

Each rule is the counterpart of vega_tpu's rule of the same id, scoped to
the port's layout: the reference's ``tpu/`` package is the port's flat
device modules (DEVICE_MODULES), and the jax spellings of VG002 and
VG006 are torch's. VG001 (the jax compat surface) has no counterpart:
the port has no compat shim (engine.NOT_PORTED). Rules are deliberately
conservative: a rule that cries wolf gets pragma'd into silence, and
then the invariant is unguarded again. The dynamic complement
(vega_tpu_torch/lint/sync_witness.py) covers what lexical analysis
cannot see at runtime.

VG002–VG008 are the per-file (and lock-graph) invariants; VG013 keeps
frame planning pure — no materialization at plan-build time; VG014
holds every exchange implementation to the (cols, count, overflow) /
n_shards==1 contract the planner relies on; VG015 funnels streaming
state mutation through the exactly-once commit API (streaming/state.py)
— and VG012's index extends into streaming/ so receiver socket reads
stay bounded. VG009–VG012 are the cross-process CONTRACT rules: a
shared per-file index pass (``_contract_extract``, cached by the
engine) reduces each file to its protocol/config/event surfaces, and
global combines join the index — every sent msg_type has a dispatch arm
and vice versa (VG009), every worker-side Configuration read is
propagated to spawned/ssh workers and every VEGA_TPU_* literal resolves
(VG010), every listener field read exists on the event schema and every
emitted event is aggregated (VG011), and no cross-process socket op
waits unbounded (VG012).

VG016–VG019 are the thread-role dataflow rules: a per-file call-graph
extraction (vega_tpu_torch/lint/callgraph.py, cached under
extract_key="callgraph" like the contract index) combines into a
project-wide call graph with roles propagated from the declared role map
— no blocking op reachable from a latency-critical role (VG016), no
driver-only state captured into executor-shipped closures (VG017), no
leaked socket/file handles on cross-process paths (VG018), and no
driver-only function reachable from a confined worker/receiver role
(VG019). Implementations live in callgraph.py; registration is here so
one import populates the whole registry.

VG020 guards the string-column invariant: device-tier code must never
create object-dtype numpy arrays — strings cross the device boundary
only as int32 dictionary codes (dict_encoding.py, the one exempt file).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from vega_tpu_torch.lint.engine import FileCtx, Finding, rule

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

PKG = "vega_tpu_torch"

# The port's device tier: the flat modules that stand where vega_tpu's
# tpu/ package stands (the dense lineage, blocks, kernels and their CUDA
# wrappers, the mesh, the exchanges and their planner, streamed sources,
# the state fold and the string dictionaries).
DEVICE_MODULES = ("block.py", "dense_rdd.py", "kernels.py",
                  "cuda_kernels.py", "mesh.py", "ring.py", "stream.py",
                  "exchange_plan.py", "state_fold.py", "dict_encoding.py")


def in_device_tier(ctx: FileCtx) -> bool:
    return any(ctx.endswith(f"{PKG}/{m}") for m in DEVICE_MODULES)


def _last_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _base_name(node: ast.AST) -> Optional[str]:
    """Leftmost identifier of an attribute chain (`a.b.c()` -> 'a')."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _kw(call: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in call.keywords)


def _own_nodes(root: ast.AST) -> Iterator[ast.AST]:
    """Descendants of `root` excluding nested function/lambda subtrees —
    the code that actually runs when `root`'s body runs."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNC_DEFS + (ast.Lambda,)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# VG002 — device probes reachable at module import time
# ---------------------------------------------------------------------------
# torch.cuda's probes initialize the CUDA runtime (or fork-poison the
# process); an import path must never run one: every module is imported
# on machines with no card, by executors that must stay off it, and by
# the tests before they pick a device.

_VG002_PROBES = {
    "torch.cuda.device_count",
    "torch.cuda.current_device",
    "torch.cuda.get_device_name",
    "torch.cuda.init",
    "torch.cuda.is_available",
}


def _is_main_guard(test: ast.AST) -> bool:
    return (isinstance(test, ast.Compare)
            and isinstance(test.left, ast.Name)
            and test.left.id == "__name__"
            and len(test.comparators) == 1
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "__main__")


@rule("VG002", "device probe reachable at module import time")
def vg002(ctx: FileCtx) -> Iterator[Finding]:
    if "cuda" not in ctx.source:
        return  # probes are torch.cuda.* calls; cheap gate saves the walk
    # Local functions that probe: a module-level call to one of them is
    # just as import-hanging as the probe itself (one hop, same module).
    probe_funcs: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, _FUNC_DEFS):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and ctx.qualified(sub.func) in _VG002_PROBES:
                    probe_funcs.add(node.name)
                    break

    findings: List[Finding] = []

    def walk(node: ast.AST, import_time: bool) -> None:
        if isinstance(node, _FUNC_DEFS):
            # Decorators and argument defaults DO run at import time;
            # the body does not.
            for d in node.decorator_list:
                walk(d, import_time)
            for d in list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None]:
                walk(d, import_time)
            for b in node.body:
                walk(b, False)
            return
        if isinstance(node, ast.Lambda):
            walk(node.body, False)
            return
        if isinstance(node, ast.If) and _is_main_guard(node.test):
            # `if __name__ == "__main__":` runs as a script entry, not on
            # import — but its ELSE branch is exactly what runs on import.
            for b in node.body:
                walk(b, False)
            for b in node.orelse:
                walk(b, import_time)
            return
        if import_time and isinstance(node, ast.Call):
            qual = ctx.qualified(node.func)
            if qual in _VG002_PROBES:
                findings.append(Finding(
                    "VG002", ctx.display, node.lineno, node.col_offset + 1,
                    f"'{qual}()' runs at module import time — CUDA "
                    "runtime init on an import path runs on every import, "
                    "card or not (and poisons forked executors)"))
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in probe_funcs:
                findings.append(Finding(
                    "VG002", ctx.display, node.lineno, node.col_offset + 1,
                    f"module-level call to '{node.func.id}()', which "
                    "probes CUDA devices — runtime init on an import "
                    "path runs on every import, card or not"))
        for child in ast.iter_child_nodes(node):
            walk(child, import_time)

    walk(ctx.tree, True)
    yield from findings


# ---------------------------------------------------------------------------
# VG003 — lock-order graph: cycles + blocking calls under cache/store locks
# ---------------------------------------------------------------------------
# The reference's seed suite froze on exactly this: two task threads
# interleaving device slicing + device_get deadlocked its runtime. The
# rule builds the acquisition graph over threading.Lock/RLock (and
# sync_witness.named_lock) attributes across vega_tpu_torch/, flags
# cycles, and flags blocking calls (host_get / .cpu() transfers, socket
# recv, Future.result, queue.get without timeout) made while holding any
# cache/store lock. Lexical nesting plus one resolvable call hop; a lock
# reached through another object's attribute resolves when exactly one
# lock in the tree has that attribute name (Context._dense_lock, an
# RLock, from the dense lineage). The runtime sync_witness covers
# dynamic orders statically invisible here.

_LOCK_CTORS = {"threading.Lock", "threading.RLock"}
_RLOCK_CTORS = {"threading.RLock"}


def _lock_ctor(call: ast.AST, ctx: FileCtx) -> Optional[bool]:
    """None if not a lock constructor; else True when reentrant."""
    if not isinstance(call, ast.Call):
        return None
    qual = ctx.qualified(call.func)
    if qual in _LOCK_CTORS:
        return qual in _RLOCK_CTORS
    if _last_name(call.func) == "named_lock":
        for k in call.keywords:
            if k.arg == "reentrant" and isinstance(k.value, ast.Constant):
                return bool(k.value.value)
        return False
    return None


# The analysis runs in two cacheable passes (engine.py result cache):
# `_vg003_extract` reduces one file to plain data — lock definitions plus
# acquisition/call/blocking sites whose lock operands are DESCRIPTORS
# (unresolved references) — and the project-wide combine resolves
# descriptors against the global lock set, builds the acquisition graph,
# and reports cycles. Descriptors defer exactly the lookups that need
# other files' lock definitions (imported locks, foreign attributes), so
# per-file extraction stays byte-stable while the rest of the tree
# changes.


def _vg003_desc(expr: ast.AST, ctx: FileCtx,
                cls: Optional[str]) -> Optional[tuple]:
    """Unresolved lock reference for a with-item / acquire operand."""
    if isinstance(expr, ast.Name):
        return ("name", ctx.module, expr.id, ctx.aliases.get(expr.id))
    if isinstance(expr, ast.Attribute):
        base = _base_name(expr)
        if base == "self" and isinstance(expr.value, ast.Name):
            return ("self", ctx.module, cls, expr.attr)
        return ("attr", ctx.qualified(expr), expr.attr, ctx.module)
    return None


def _vg003_resolve(desc: Optional[tuple],
                   locks: Dict[str, bool]) -> Optional[str]:
    """Descriptor -> lock key, given every file's lock definitions."""
    if desc is None:
        return None
    kind = desc[0]
    if kind == "name":
        _, module, name, alias = desc
        key = f"{module}.{name}"
        if key in locks:
            return key
        if alias and alias in locks:
            return alias
        return key if "lock" in name.lower() else None
    if kind == "self":
        _, module, cls, attr = desc
        if cls is None:
            return None
        key = f"{module}.{cls}.{attr}"
        return key if (key in locks or "lock" in attr.lower()) else None
    _, qual, attr, module = desc
    if qual and qual in locks:
        return qual
    owners = [k for k in locks if k.rsplit(".", 1)[-1] == attr]
    if len(owners) == 1:
        return owners[0]  # the one lock in the tree with this attribute
    if "lock" in attr.lower():
        return f"{module}.?.{attr}"  # opaque foreign lock
    return None


_CACHEISH = ("cache", "store")


def _is_cacheish(key: str) -> bool:
    low = key.lower()
    return any(s in low for s in _CACHEISH)


def _blocking_desc(call: ast.Call) -> Optional[str]:
    name = _last_name(call.func)
    if name in ("device_get", "host_get") or (
            name == "cpu" and not call.args and not call.keywords):
        return f"{name}() (a driver<->device round trip)"
    if name == "recv":
        return "socket recv()"
    if name == "result" and not call.args and not _kw(call, "timeout"):
        return "Future.result() without timeout"
    if name == "get" and isinstance(call.func, ast.Attribute) \
            and not call.args and not _kw(call, "timeout"):
        recv = _base_name(call.func) or ""
        attr_chain = call.func.value
        attr = attr_chain.attr if isinstance(attr_chain, ast.Attribute) \
            else recv
        if "queue" in (attr or "").lower() or "queue" in recv.lower():
            return "queue get() without timeout"
    return None


def _vg003_scan_fn(body: List[ast.stmt], ctx: FileCtx, cls: Optional[str],
                   fname: str, data: dict) -> None:
    direct: List[tuple] = []
    nested: List[Tuple[List[ast.stmt], Optional[str], str]] = []

    def walk(node: ast.AST, held: List[tuple]) -> None:
        if isinstance(node, _FUNC_DEFS):
            nested.append((node.body, cls, node.name))
            return  # a nested def runs later, not under the held locks
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.With):
            here: List[tuple] = []
            for item in node.items:
                walk(item.context_expr, held + here)
                desc = _vg003_desc(item.context_expr, ctx, cls)
                if desc is None:
                    continue
                data["acquires"].append(
                    (held + here, desc, item.context_expr.lineno))
                here = here + [desc]
                direct.append(desc)
            for b in node.body:
                walk(b, held + here)
            return
        if isinstance(node, ast.Call):
            desc = _blocking_desc(node)
            if desc and held:
                data["blocking"].append(
                    (desc, list(held), node.lineno, node.col_offset + 1))
            if held:
                callee: Optional[Tuple] = None
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == "self" and cls:
                    callee = (ctx.module, cls, f.attr)
                elif isinstance(f, ast.Name):
                    callee = (ctx.module, None, f.id)
                if callee is not None:
                    data["calls"].append(
                        (list(held), callee, node.lineno))
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for stmt in body:
        walk(stmt, [])
    data["fn_locks"].setdefault((ctx.module, cls, fname),
                                []).extend(direct)
    for nbody, ncls, nname in nested:
        _vg003_scan_fn(nbody, ctx, ncls, nname, data)


def _vg003_extract(ctx: FileCtx) -> Optional[dict]:
    """Per-file half of VG003: lock definitions + unresolved acquisition/
    call/blocking sites (cached by the engine; combine resolves them)."""
    if not ctx.in_dir(PKG):
        return None
    data: dict = {"locks": {}, "acquires": [], "fn_locks": {},
                  "calls": [], "blocking": []}
    # Lock definitions (module-level names and self.X attributes).
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) \
                and isinstance(node.targets[0], ast.Name):
            r = _lock_ctor(node.value, ctx)
            if r is not None:
                data["locks"][f"{ctx.module}.{node.targets[0].id}"] = r
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Assign):
                continue
            r = _lock_ctor(sub.value, ctx)
            if r is None:
                continue
            t = sub.targets[0]
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                data["locks"][f"{ctx.module}.{node.name}.{t.attr}"] = r
            elif isinstance(t, ast.Name):  # class-body lock (Env._lock)
                data["locks"][f"{ctx.module}.{node.name}.{t.id}"] = r
    # Acquisitions — module body, functions, methods.
    _vg003_scan_fn(
        [s for s in ctx.tree.body
         if not isinstance(s, _FUNC_DEFS + (ast.ClassDef,))],
        ctx, None, "<module>", data)
    for node in ctx.tree.body:
        if isinstance(node, _FUNC_DEFS):
            _vg003_scan_fn(node.body, ctx, None, node.name, data)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, _FUNC_DEFS):
                    _vg003_scan_fn(sub.body, ctx, node.name,
                                   sub.name, data)
    if not (data["locks"] or data["acquires"] or data["calls"]
            or data["blocking"]):
        return None
    return data


@rule("VG003", "lock-order cycles and blocking calls under cache/store "
      "locks", project=True, extract=_vg003_extract)
def vg003(records: List[Tuple[str, dict]]) -> Iterator[Finding]:
    # Pass 1: the global lock set (descriptor resolution needs it).
    locks: Dict[str, bool] = {}
    for _display, data in records:
        locks.update(data["locks"])
    findings: List[Finding] = []
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    fn_locks: Dict[Tuple, Set[str]] = {}
    # Pass 2: resolve acquisition sites into graph edges + blocking
    # findings, in file order (first site wins, as before the split).
    for display, data in records:
        for held_descs, desc, line in data["acquires"]:
            key = _vg003_resolve(desc, locks)
            if key is None:
                continue
            for h_desc in held_descs:
                h = _vg003_resolve(h_desc, locks)
                if h is None:
                    continue
                if h == key and locks.get(key):
                    continue  # reentrant re-acquire is fine
                edges.setdefault((h, key), (display, line))
        for fn_key, descs in data["fn_locks"].items():
            fn_locks.setdefault(fn_key, set()).update(
                k for k in (_vg003_resolve(d, locks) for d in descs)
                if k is not None)
        for desc_text, held_descs, line, col in data["blocking"]:
            held = [k for k in (_vg003_resolve(d, locks)
                                for d in held_descs) if k is not None]
            cacheish = [h for h in held if _is_cacheish(h)]
            if cacheish:
                findings.append(Finding(
                    "VG003", display, line, col,
                    f"blocking {desc_text} while holding cache/store lock "
                    f"'{cacheish[-1]}' — can deadlock or starve every "
                    "other task thread waiting on the cache"))
    # Pass 3: one call hop — held locks flow into the callee's direct set.
    for display, data in records:
        for held_descs, callee, line in data["calls"]:
            held = [k for k in (_vg003_resolve(d, locks)
                                for d in held_descs) if k is not None]
            if not held:
                continue
            for key in fn_locks.get(tuple(callee), ()):
                for h in held:
                    if h == key and locks.get(key):
                        continue
                    edges.setdefault((h, key), (display, line))
    # Pass 4: cycles (including non-reentrant self-acquisition).
    adj: Dict[str, Set[str]] = {}
    for (a, b), _site in edges.items():
        adj.setdefault(a, set()).add(b)
    seen_cycles: Set[Tuple[str, ...]] = set()
    for (a, b), (display, line) in sorted(edges.items(),
                                          key=lambda kv: kv[1]):
        if a == b:
            findings.append(Finding(
                "VG003", display, line, 1,
                f"non-reentrant lock '{a}' re-acquired while already "
                "held — self-deadlock"))
            continue
        path = _find_path(adj, b, a)
        if path is None:
            continue
        cycle = [a] + path[:-1]  # path ends at a; drop the repeat
        lo = cycle.index(min(cycle))
        canon = tuple(cycle[lo:] + cycle[:lo])
        if canon in seen_cycles:
            continue
        seen_cycles.add(canon)
        findings.append(Finding(
            "VG003", display, line, 1,
            "lock-order cycle: " + " -> ".join(cycle + [cycle[0]])
            + " — two threads taking these in opposite order deadlock"))
    yield from findings


def _find_path(adj: Dict[str, Set[str]], src: str,
               dst: str) -> Optional[List[str]]:
    """BFS path src..dst (inclusive of src, exclusive of repeat of dst)."""
    if src == dst:
        return [src]
    parent: Dict[str, str] = {src: src}
    frontier = [src]
    while frontier:
        nxt: List[str] = []
        for u in frontier:
            for v in sorted(adj.get(u, ())):
                if v in parent:
                    continue
                parent[v] = u
                if v == dst:
                    path = [v]
                    while path[-1] != src:
                        path.append(parent[path[-1]])
                    return list(reversed(path))
                nxt.append(v)
        frontier = nxt
    return None


# ---------------------------------------------------------------------------
# VG004 — purity of hash_placed / key_sorted property readers
# ---------------------------------------------------------------------------
# A bare property read must never launch an exchange (round-4 advisor):
# exchange planners call _settle_placement() explicitly first. A reader
# that materializes turns an innocent `if rdd.hash_placed:` into device
# work — silently, at unpredictable times.

_VG004_READERS = {"hash_placed", "key_sorted"}
_VG004_IMPURE_CALLS = {
    "_settle_placement", "_materialize", "block", "collect", "to_numpy",
    "device_get", "host_get", "compute", "splits",
}
_VG004_IMPURE_ATTRS = {"counts_np", "num_rows"}


@rule("VG004", "hash_placed/key_sorted property readers must stay pure")
def vg004(ctx: FileCtx) -> Iterator[Finding]:
    if not ctx.in_dir(PKG):
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, _FUNC_DEFS)
                and node.name in _VG004_READERS):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = _last_name(sub.func)
                if name in _VG004_IMPURE_CALLS:
                    yield Finding(
                        "VG004", ctx.display, sub.lineno,
                        sub.col_offset + 1,
                        f"'{node.name}' reader calls '{name}()' — "
                        "placement property reads are PURE; planners "
                        "call _settle_placement() explicitly (CLAUDE.md)")
            elif isinstance(sub, ast.Attribute) \
                    and sub.attr in _VG004_IMPURE_ATTRS:
                yield Finding(
                    "VG004", ctx.display, sub.lineno, sub.col_offset + 1,
                    f"'{node.name}' reader touches '.{sub.attr}' (device "
                    "materialization) — placement property reads are PURE")


# ---------------------------------------------------------------------------
# VG005 — blind broad excepts in distributed/ shuffle/ scheduler/
# ---------------------------------------------------------------------------
# A swallowed exception in the control plane turns a crash into a hang
# (the chaos harness exists because of these). Broad handlers must log or
# re-raise (typed VegaError included) — silence is the only failure.

_VG005_DIRS = ((PKG, "distributed"), (PKG, "shuffle"),
               (PKG, "scheduler"))
_LOG_RECEIVERS = {"log", "logger", "logging"}
_LOG_METHODS = {"debug", "info", "warning", "error", "exception",
                "critical", "log"}


def _handler_is_broad(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(isinstance(n, ast.Name)
               and n.id in ("Exception", "BaseException") for n in names)


@rule("VG005", "broad except that neither logs nor re-raises")
def vg005(ctx: FileCtx) -> Iterator[Finding]:
    if not any(ctx.in_dir(*d) for d in _VG005_DIRS):
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.ExceptHandler)
                and _handler_is_broad(node)):
            continue
        ok = False
        for sub in _own_nodes(node):
            if isinstance(sub, ast.Raise):
                ok = True
                break
            if isinstance(sub, ast.Call):
                name = _last_name(sub.func)
                base = _base_name(sub.func)
                if (base in _LOG_RECEIVERS and name in _LOG_METHODS) \
                        or (base == "warnings" and name == "warn") \
                        or (base == "traceback"
                            and name == "print_exc"):
                    ok = True
                    break
        if not ok:
            yield Finding(
                "VG005", ctx.display, node.lineno, node.col_offset + 1,
                "broad except swallows the error silently — log it or "
                "re-raise a typed VegaError (a swallowed control-plane "
                "exception turns a crash into a hang)")


# ---------------------------------------------------------------------------
# VG006 — host syncs inside device functions
# ---------------------------------------------------------------------------
# The port's device functions run eagerly on the card: a .item() /
# .tolist(), an int()/bool()/float() of a tensor, or a nonzero/unique
# (whose output size only the card knows) waits for every queued kernel
# and copies to the host. Inside a kernel module's function, or one handed
# to torch's compilers, that is a stall in the middle of the device work
# (and a graph break or a trace error under compile/script/trace). The
# device functions are the module-level functions of kernels.py and
# cuda_kernels.py (what vega_tpu's tpu/kernels.py and pallas_kernels.py
# hold) and any function passed to or decorated with a torch compiler.

_TRACED_FILES = (f"{PKG}/kernels.py", f"{PKG}/cuda_kernels.py")
_TRACER_NAMES = {"compile", "script", "trace", "vmap"}
_SIZED_OPS = {"nonzero", "unique", "argwhere", "unique_consecutive"}
_SYNC_METHODS = {"item", "tolist"}


def _is_array_expr(node: ast.AST, ctx: FileCtx) -> bool:
    """Heuristic: a Compare, or a call into torch, or a reduction method
    call — the expressions whose int()/bool() coercion syncs a tensor."""
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.Call):
        qual = ctx.qualified(node.func)
        if qual and qual.startswith("torch."):
            return True
        if isinstance(node.func, ast.Attribute) and _last_name(
                node.func) in ("any", "all", "sum", "max", "min"):
            return True
    return False


def _traced_nodes(ctx: FileCtx) -> List[ast.AST]:
    traced: List[ast.AST] = []
    names: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) \
                and _last_name(node.func) in _TRACER_NAMES \
                and (ctx.qualified(node.func) or "").startswith("torch."):
            for arg in node.args:
                if isinstance(arg, ast.Name):
                    names.add(arg.id)
                elif isinstance(arg, (ast.Lambda,)):
                    traced.append(arg)
    module_level = any(ctx.endswith(f) for f in _TRACED_FILES)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, _FUNC_DEFS):
            continue
        decorated = any(
            (ctx.qualified(d.func if isinstance(d, ast.Call) else d)
             or "").startswith("torch.")
            and _last_name(d.func if isinstance(d, ast.Call) else d)
            in _TRACER_NAMES
            for d in node.decorator_list)
        if node.name in names or decorated \
                or (module_level and node in ctx.tree.body):
            traced.append(node)
    return traced


@rule("VG006", "host syncs (.item / .tolist / int()/bool() of a tensor / "
      "nonzero / unique) inside device functions")
def vg006(ctx: FileCtx) -> Iterator[Finding]:
    if not in_device_tier(ctx):
        return
    seen: Set[int] = set()
    for root in _traced_nodes(ctx):
        for sub in ast.walk(root):
            if id(sub) in seen or not isinstance(sub, ast.Call):
                continue
            seen.add(id(sub))
            name = _last_name(sub.func)
            qual = ctx.qualified(sub.func) or ""
            if name in _SYNC_METHODS and isinstance(sub.func, ast.Attribute) \
                    and not sub.args:
                yield Finding(
                    "VG006", ctx.display, sub.lineno, sub.col_offset + 1,
                    f".{name}() inside a device function waits for the "
                    "card and copies to the host — host-side folds belong "
                    "outside the device function")
            elif isinstance(sub.func, ast.Name) \
                    and sub.func.id in ("int", "bool", "float") \
                    and sub.args and _is_array_expr(sub.args[0], ctx):
                yield Finding(
                    "VG006", ctx.display, sub.lineno, sub.col_offset + 1,
                    f"{sub.func.id}() of a tensor expression — a host sync "
                    "inside a device function; keep it a tensor "
                    "(torch.where) or decide on the host")
            elif name in _SIZED_OPS and (
                    qual.startswith("torch.")
                    or (isinstance(sub.func, ast.Attribute)
                        and not qual.startswith("numpy."))):
                yield Finding(
                    "VG006", ctx.display, sub.lineno,
                    sub.col_offset + 1,
                    f"'{name}' in a device function — its output size is "
                    "known only on the card, so it syncs; use a static "
                    "capacity (mask + cumsum, the static-shapes "
                    "invariant)")


# ---------------------------------------------------------------------------
# VG007 — pool starvation: blocking on a shared executor from inside it
# ---------------------------------------------------------------------------
# A pool with every thread busy (one thread per task at num_workers=1)
# starves a task that submits to its own pool and blocks on the Future:
# it waits on work queued behind itself. Draining a pool you created locally is fine; blocking on a
# shared/ambient pool's Future is the hazard.

_POOL_CTORS = {"ThreadPoolExecutor", "ProcessPoolExecutor"}


@rule("VG007", "submit + blocking wait on a shared executor in one "
      "function")
def vg007(ctx: FileCtx) -> Iterator[Finding]:
    if not ctx.in_dir(PKG):
        return
    for fn in [n for n in ast.walk(ctx.tree) if isinstance(n, _FUNC_DEFS)]:
        local_pools: Set[str] = set()
        submits: List[Tuple[int, int, str]] = []
        waits: List[Tuple[int, int, str]] = []
        own = list(_own_nodes(fn))
        # Pass 1: pools this function creates itself (draining those is
        # legal — the deadlock needs the pool to be shared).
        for sub in own:
            if isinstance(sub, ast.Assign) \
                    and isinstance(sub.value, ast.Call) \
                    and _last_name(sub.value.func) in _POOL_CTORS:
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        local_pools.add(t.id)
            if isinstance(sub, ast.withitem) \
                    and isinstance(sub.context_expr, ast.Call) \
                    and _last_name(sub.context_expr.func) in _POOL_CTORS \
                    and isinstance(sub.optional_vars, ast.Name):
                local_pools.add(sub.optional_vars.id)
        for sub in own:
            if not isinstance(sub, ast.Call):
                continue
            name = _last_name(sub.func)
            if name == "submit" and isinstance(sub.func, ast.Attribute):
                base = _base_name(sub.func)
                if base not in local_pools:
                    submits.append((sub.lineno, sub.col_offset + 1,
                                    base or "?"))
            elif name == "result" and not _kw(sub, "timeout") \
                    and not sub.args:
                waits.append((sub.lineno, sub.col_offset + 1,
                              "Future.result()"))
            elif name == "as_completed" or (
                    name == "wait"
                    and (ctx.qualified(sub.func) or "").endswith(
                        "futures.wait")
                    and not _kw(sub, "timeout")):
                waits.append((sub.lineno, sub.col_offset + 1, name))
        if submits and waits:
            line, col, desc = waits[0]
            yield Finding(
                "VG007", ctx.display, line, col,
                f"blocking {desc} in a function that also submits to "
                f"shared executor '{submits[0][2]}' — on the 1-thread-"
                "per-task pool this starves (task waits on work queued "
                "behind itself); drain a locally-created pool instead")


# ---------------------------------------------------------------------------
# VG008 — DAG scheduler job entries must route through the job server
# ---------------------------------------------------------------------------
# Every job — blocking or async — goes through
# scheduler/jobserver.py so fair-scheduling pools, per-pool quotas, and
# cancellation apply uniformly. A direct DAGScheduler.run_job /
# run_job_with_listener / _run_job_inner call anywhere else silently
# bypasses the arbiter: that job's tasks go straight to the backend,
# monopolizing slots no quota can reclaim. Allowed callers: context.py
# (the public facade), rdd/ (actions call context.run_job — a Context
# method, not the scheduler's), jobserver.py (the route itself), and
# scheduler/dag.py (the implementation's own internals).

_VG008_ALLOWED_SUFFIXES = (
    f"{PKG}/context.py",
    f"{PKG}/scheduler/dag.py",
    f"{PKG}/scheduler/jobserver.py",
)
_VG008_ENTRIES = {"run_job", "run_job_with_listener"}


@rule("VG008", "DAGScheduler job entry called outside the job-server route")
def vg008(ctx: FileCtx) -> Iterator[Finding]:
    if any(ctx.endswith(s) for s in _VG008_ALLOWED_SUFFIXES) \
            or ctx.in_dir(PKG, "rdd"):
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        attr = node.func.attr
        if attr == "_run_job_inner":
            yield Finding(
                "VG008", ctx.display, node.lineno, node.col_offset + 1,
                "_run_job_inner is the job server's private entry — "
                "submit through Context.submit_job/run_job so pools, "
                "quotas and cancellation apply")
            continue
        if attr not in _VG008_ENTRIES:
            continue
        # Only scheduler-shaped receivers: `self.scheduler.run_job`,
        # `ctx.scheduler.run_job`, a local named `scheduler`, or a direct
        # `DAGScheduler(...)` construction. Context.run_job (the facade
        # that DOES route through the server) stays legal everywhere.
        recv = node.func.value
        qual = (ctx.qualified(recv) or "").lower()
        last = ""
        if isinstance(recv, ast.Attribute):
            last = recv.attr
        elif isinstance(recv, ast.Name):
            last = recv.id
        ctor = _last_name(recv.func) if isinstance(recv, ast.Call) else None
        if "scheduler" in qual or "scheduler" in last.lower() \
                or ctor == "DAGScheduler":
            yield Finding(
                "VG008", ctx.display, node.lineno, node.col_offset + 1,
                f"direct DAGScheduler.{attr} call bypasses the job "
                "server (no pool/quota arbitration, no cancellation) — "
                "route through Context.submit_job/run_job")


# ---------------------------------------------------------------------------
# Contract index — the shared per-file extraction behind VG009-VG011
# ---------------------------------------------------------------------------
# PRs 4-8 grew three cross-process contract surfaces: the framed-TCP
# message grammar (protocol.py), the Configuration -> env -> spawned/ssh
# worker knob pipeline (env.py + backend._worker_knobs), and the job-scoped
# event-bus schema (scheduler/events.py). Each is enforced only at runtime
# otherwise, and a typo in any of them is a silent cross-process wedge.
# One walk per file reduces the surfaces to plain data (cached by the
# engine); the rules below are global joins over that index.

_VG009_SEND_ARG = {"send_msg": 1, "encode_msg": 0, "_call": 0}
_VG009_DISPATCH_VARS = {"msg_type", "reply_type", "marker"}
_ENV_NAME_RE = re.compile(r"VEGA_TPU_[A-Z0-9_]*[A-Z0-9]")
# Infrastructure knobs that are deliberately NOT Configuration fields:
# the sync-witness switch, the hardware-test gate, and the lint engine's
# own cache override.
_VG010_ALLOWLIST = {"VEGA_TPU_DEBUG_SYNC", "VEGA_TPU_HW_TESTS",
                    "VEGA_TPU_LINT_CACHE"}
_VG010_WORKER_SIDE = ("distributed/worker.py",
                      "distributed/shuffle_server.py")


def _docstring_ids(tree: ast.AST) -> Set[int]:
    """ids of docstring Constant nodes (module/class/function bodies)."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef) + _FUNC_DEFS):
            body = getattr(node, "body", [])
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                out.add(id(body[0].value))
    return out


def _conf_receiver(node: ast.AST) -> bool:
    """True for conf / self.conf / env.conf / Env.get().conf receivers."""
    return (isinstance(node, ast.Name) and node.id == "conf") or \
        (isinstance(node, ast.Attribute) and node.attr == "conf")


def _event_reads_of(fn: ast.AST) -> List[tuple]:
    """Attribute loads on `event` inside an on_event listener, with
    isinstance narrowing: reads in the body (and test) of an
    `if isinstance(event, X):` are checked against X's fields only."""
    reads: List[tuple] = []

    def isinstance_classes(test: ast.AST) -> List[str]:
        found: List[str] = []
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call) \
                    and _last_name(sub.func) == "isinstance" \
                    and len(sub.args) == 2 \
                    and isinstance(sub.args[0], ast.Name) \
                    and sub.args[0].id == "event":
                t = sub.args[1]
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                found.extend(n for n in (_last_name(e) for e in elts) if n)
        return found

    def walk(node: ast.AST, narrow: Optional[tuple]) -> None:
        if isinstance(node, ast.If):
            classes = isinstance_classes(node.test)
            inner = tuple(classes) if classes else narrow
            walk_children(node.test, inner)
            for b in node.body:
                walk(b, inner)
            for b in node.orelse:
                walk(b, narrow)
            return
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "event" \
                and isinstance(node.ctx, ast.Load):
            reads.append((node.attr, node.lineno, node.col_offset + 1,
                          narrow))
        walk_children(node, narrow)

    def walk_children(node: ast.AST, narrow: Optional[tuple]) -> None:
        for child in ast.iter_child_nodes(node):
            walk(child, narrow)

    for stmt in fn.body:
        walk(stmt, None)
    return reads


def _contract_extract(ctx: FileCtx) -> Optional[dict]:
    out: dict = {}
    docstrings = _docstring_ids(ctx.tree)

    # --- protocol sends + dispatch arms (the framed-TCP grammar) -------
    if ctx.in_dir(PKG, "distributed"):
        sends: List[tuple] = []
        arms: List[tuple] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = _last_name(node.func)
                idx = _VG009_SEND_ARG.get(name)
                if name == "request":
                    idx = 2
                if idx is not None and len(node.args) > idx \
                        and isinstance(node.args[idx], ast.Constant) \
                        and isinstance(node.args[idx].value, str):
                    sends.append((node.args[idx].value, node.lineno,
                                  node.col_offset + 1))
            elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                    and isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
                for var, lit in ((node.left, node.comparators[0]),
                                 (node.comparators[0], node.left)):
                    if isinstance(var, ast.Name) \
                            and var.id in _VG009_DISPATCH_VARS \
                            and isinstance(lit, ast.Constant) \
                            and isinstance(lit.value, str):
                        arms.append((lit.value, node.lineno,
                                     node.col_offset + 1))
        if sends:
            out["sends"] = sends
        if arms:
            out["arms"] = arms

    # --- worker-side Configuration reads + the propagation list --------
    if ctx.in_dir(PKG, "shuffle") \
            or any(ctx.endswith(s) for s in _VG010_WORKER_SIDE):
        reads: List[tuple] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load) \
                    and _conf_receiver(node.value):
                reads.append((node.attr, node.lineno, node.col_offset + 1))
            elif isinstance(node, ast.Call) \
                    and _last_name(node.func) == "getattr" \
                    and len(node.args) >= 2 \
                    and _conf_receiver(node.args[0]) \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                reads.append((node.args[1].value, node.lineno,
                              node.col_offset + 1))
        if reads:
            out["knob_reads"] = reads
    if ctx.endswith("distributed/backend.py"):
        propagated: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg and kw.arg.startswith("VEGA_TPU_"):
                        propagated.add(kw.arg)
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and id(node) not in docstrings:
                m = re.match(r"(VEGA_TPU_[A-Z0-9_]*[A-Z0-9])(=|$)",
                             node.value)
                if m:
                    propagated.add(m.group(1))
        if propagated:
            out["propagation"] = sorted(propagated)

    # --- Configuration fields + fault knobs (resolution targets) -------
    if ctx.endswith(f"{PKG}/env.py"):
        fields = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) \
                    and node.name == "Configuration":
                fields = [s.target.id for s in node.body
                          if isinstance(s, ast.AnnAssign)
                          and isinstance(s.target, ast.Name)]
        if fields:
            out["config_fields"] = fields
    if ctx.endswith(f"{PKG}/faults.py"):
        knobs = sorted({
            node.value for node in ast.walk(ctx.tree)
            if isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and id(node) not in docstrings
            and re.fullmatch(r"[A-Z][A-Z0-9_]*[A-Z0-9]", node.value)})
        if knobs:
            out["fault_knobs"] = knobs

    # --- every VEGA_TPU_* env literal (typo class) ----------------------
    if "VEGA_TPU_" in ctx.source:
        env_lits: List[tuple] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and id(node) not in docstrings \
                    and "VEGA_TPU_" in node.value:
                for m in _ENV_NAME_RE.finditer(node.value):
                    end = m.end()
                    if end < len(node.value) and node.value[end] == "_":
                        continue  # a prefix constant ("VEGA_TPU_FAULT_")
                    env_lits.append((m.group(0), node.lineno,
                                     node.col_offset + 1))
        if env_lits:
            out["env_literals"] = env_lits

    # --- event schema: classes, listener reads, emissions ---------------
    if ctx.endswith("scheduler/events.py"):
        classes: Dict[str, List[str]] = {}
        aggregated: List[str] = []
        for node in ctx.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            bases = {_last_name(b) for b in node.bases}
            if node.name == "Event" or "Event" in bases:
                classes[node.name] = [
                    s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)]
            if node.name == "MetricsListener":
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) \
                            and _last_name(sub.func) == "isinstance" \
                            and len(sub.args) == 2:
                        t = sub.args[1]
                        elts = t.elts if isinstance(t, ast.Tuple) else [t]
                        aggregated.extend(
                            n for n in (_last_name(e) for e in elts) if n)
        if classes:
            out["event_classes"] = classes
            out["event_aggregated"] = sorted(set(aggregated))
    if "on_event" in ctx.source:
        event_reads: List[tuple] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, _FUNC_DEFS) and node.name == "on_event":
                event_reads.extend(_event_reads_of(node))
        if event_reads:
            out["event_reads"] = event_reads
    # Emission sites resolve through the alias map, so a file with no
    # import landing on scheduler.events cannot emit — skip the walk.
    if any("scheduler.events" in v for v in ctx.aliases.values()):
        emits: List[tuple] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                qual = ctx.qualified(node.func)
                if qual and "scheduler.events." in qual:
                    emits.append((qual.rsplit(".", 1)[1], node.lineno,
                                  node.col_offset + 1))
        if emits:
            out["event_emits"] = emits

    return out or None


# ---------------------------------------------------------------------------
# VG009 — protocol conformance: every sent msg_type has a dispatch arm,
# every dispatch arm has a sender
# ---------------------------------------------------------------------------
# The message grammar lives in protocol.py prose; the send sites and the
# role handlers (worker._TaskHandler / shuffle_server._Handler /
# DriverService.dispatch, plus the client-side reply loops) are the code.
# The reference's unknown-task_v2-marker desync was exactly a grammar/handler
# drift. A string sent via send_msg/encode_msg/request/_call with no
# `msg_type ==` (or reply_type/marker) arm anywhere in distributed/ is an
# unhandleable message; an arm no send site can reach is a dead handler.

@rule("VG009", "protocol message without dispatch arm / dead dispatch "
      "arm", project=True, extract=_contract_extract,
      extract_key="contracts")
def vg009(records: List[Tuple[str, dict]]) -> Iterator[Finding]:
    sends: Dict[str, tuple] = {}
    arms: Dict[str, tuple] = {}
    for display, data in records:
        for lit, line, col in data.get("sends", ()):
            sends.setdefault(lit, (display, line, col))
        for lit, line, col in data.get("arms", ()):
            arms.setdefault(lit, (display, line, col))
    if not sends or not arms:
        return  # no protocol surface in this tree
    for lit in sorted(set(sends) - set(arms)):
        display, line, col = sends[lit]
        yield Finding(
            "VG009", display, line, col,
            f"protocol message '{lit}' is sent but no dispatch arm "
            "compares msg_type/reply_type/marker against it — the "
            "receiver answers 'unknown' (or desyncs) at runtime; add the "
            "arm or fix the typo (grammar: distributed/protocol.py)")
    for lit in sorted(set(arms) - set(sends)):
        display, line, col = arms[lit]
        yield Finding(
            "VG009", display, line, col,
            f"dispatch arm for '{lit}' has no send site in the tree — "
            "dead handler: either wire up a sender or delete the arm "
            "(grammar: distributed/protocol.py)")


# ---------------------------------------------------------------------------
# VG010 — knob propagation: worker-side Configuration reads must reach
# spawned/ssh workers; every VEGA_TPU_* literal must resolve
# ---------------------------------------------------------------------------
# Context(conf=...) overrides only exist in the DRIVER process; a
# Configuration field read on the worker side (worker.py,
# shuffle_server.py, shuffle/) is silently stuck at its default in every
# spawned or ssh executor unless backend.py propagates the VEGA_TPU_*
# env var. And a typo'd env literal anywhere (tests included) configures
# nothing while looking like it does.

@rule("VG010", "worker-side Configuration read not propagated to "
      "workers / unresolvable VEGA_TPU_* env literal", project=True,
      extract=_contract_extract, extract_key="contracts")
def vg010(records: List[Tuple[str, dict]]) -> Iterator[Finding]:
    fields: Set[str] = set()
    fault_knobs: Set[str] = set()
    propagated: Set[str] = set()
    for _display, data in records:
        fields.update(data.get("config_fields", ()))
        fault_knobs.update(data.get("fault_knobs", ()))
        propagated.update(data.get("propagation", ()))
    if not fields:
        return  # no Configuration in this tree: nothing to resolve against
    if propagated:
        seen: Set[str] = set()
        for display, data in records:
            for field, line, col in data.get("knob_reads", ()):
                if field not in fields or field in seen:
                    continue
                seen.add(field)
                env_name = "VEGA_TPU_" + field.upper()
                if env_name not in propagated:
                    yield Finding(
                        "VG010", display, line, col,
                        f"worker-side read of Configuration.{field} but "
                        f"{env_name} is not in backend.py's worker "
                        "propagation list — driver-side overrides "
                        "silently never reach spawned/ssh executors "
                        "(add it to _worker_knobs)")
    for display, data in records:
        for name, line, col in data.get("env_literals", ()):
            if name in _VG010_ALLOWLIST:
                continue
            if name.startswith("VEGA_TPU_FAULT_"):
                if name[len("VEGA_TPU_FAULT_"):] in fault_knobs:
                    continue
            elif name[len("VEGA_TPU_"):].lower() in fields:
                continue
            yield Finding(
                "VG010", display, line, col,
                f"env literal '{name}' resolves to no Configuration "
                "field, faults.py knob, or known infrastructure knob — "
                "a typo here configures nothing while looking like it "
                "does")


# ---------------------------------------------------------------------------
# VG011 — event-schema conformance: listener reads exist on the event
# classes; every emitted event type is aggregated
# ---------------------------------------------------------------------------
# The bus delivers plain dataclasses; a misspelled attribute in a
# listener is an AttributeError swallowed by the bus's listener guard
# (log + continue), i.e. silently missing metrics. Reads inside an
# `isinstance(event, X)` branch are checked against X's own fields;
# un-narrowed reads pass if ANY event class has the field. An event type
# that is emitted but never aggregated by MetricsListener is invisible
# in every summary — aggregate it or pragma the emit site.

@rule("VG011", "listener reads a nonexistent event field / emitted "
      "event type not aggregated", project=True,
      extract=_contract_extract, extract_key="contracts")
def vg011(records: List[Tuple[str, dict]]) -> Iterator[Finding]:
    classes: Dict[str, Set[str]] = {}
    aggregated: Set[str] = set()
    for _display, data in records:
        for cls, fields in data.get("event_classes", {}).items():
            classes[cls] = set(fields)
        aggregated.update(data.get("event_aggregated", ()))
    if not classes:
        return  # no scheduler/events.py in this tree
    base = classes.get("Event", set())
    union: Set[str] = set(base)
    for fields in classes.values():
        union.update(fields)
    for display, data in records:
        for attr, line, col, narrow in data.get("event_reads", ()):
            if narrow:
                known = [c for c in narrow if c in classes]
                if not known:
                    continue  # narrowed to a non-bus class: out of scope
                ok = any(attr in classes[c] | base for c in known)
                scope = "/".join(known)
            else:
                ok = attr in union
                scope = "any event class"
            if not ok:
                yield Finding(
                    "VG011", display, line, col,
                    f"listener reads event.{attr}, which does not exist "
                    f"on {scope} (scheduler/events.py) — the bus guard "
                    "swallows the AttributeError, so this metric is "
                    "silently never recorded")
    emitted: Dict[str, tuple] = {}
    for display, data in records:
        for cls, line, col in data.get("event_emits", ()):
            if cls in classes and cls != "Event":
                emitted.setdefault(cls, (display, line, col))
    for cls in sorted(set(emitted) - aggregated):
        display, line, col = emitted[cls]
        yield Finding(
            "VG011", display, line, col,
            f"event type {cls} is emitted but MetricsListener never "
            "aggregates it — it is invisible in metrics_summary(); "
            "aggregate it or justify the emit site with a pragma")


# ---------------------------------------------------------------------------
# VG012 — unbounded blocking socket ops in distributed/ and shuffle/
# ---------------------------------------------------------------------------
# The hung-owner class: a hung shuffle owner gated a reduce task on the full
# 120s IO_TIMEOUT because one socket op ran without the push plan's
# deadline. On cross-process paths every raw recv/recv_into, connect
# without timeout, Future.result() without timeout, and settimeout(None)
# is a wait no deadline bounds — flag them all; the handful of
# deliberate unbounded waits carry justified pragmas.

_VG012_DIRS = ((PKG, "distributed"), (PKG, "shuffle"),
               # Streaming receivers read sockets too: a silent peer must
               # never wedge an ingest thread unboundedly.
               (PKG, "streaming"))


@rule("VG012", "unbounded blocking socket op on a cross-process path")
def vg012(ctx: FileCtx) -> Iterator[Finding]:
    if not any(ctx.in_dir(*d) for d in _VG012_DIRS):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _last_name(node.func)
        if name in ("recv", "recv_into") \
                and isinstance(node.func, ast.Attribute):
            yield Finding(
                "VG012", ctx.display, node.lineno, node.col_offset + 1,
                f"raw socket {name}() — nothing here bounds the wait; a "
                "hung peer parks this thread for the socket's full "
                "timeout (or forever). Route through the protocol "
                "helpers on a deadline-bearing socket, or justify with "
                "a pragma")
        elif name == "settimeout" and len(node.args) == 1 \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value is None:
            yield Finding(
                "VG012", ctx.display, node.lineno, node.col_offset + 1,
                "settimeout(None) removes the socket deadline — a hung "
                "peer now gates this path forever (the hung-owner "
                "class); bound it or justify the unbounded wait with a "
                "pragma")
        elif name == "create_connection" and not _kw(node, "timeout") \
                and len(node.args) < 2:
            yield Finding(
                "VG012", ctx.display, node.lineno, node.col_offset + 1,
                "create_connection without timeout blocks the full OS "
                "connect timeout on a SYN-blackholed peer — pass "
                "timeout= (protocol.connect does)")
        elif name == "result" and not node.args \
                and not _kw(node, "timeout") \
                and isinstance(node.func, ast.Attribute):
            yield Finding(
                "VG012", ctx.display, node.lineno, node.col_offset + 1,
                "Future.result() without timeout on a cross-process "
                "path — a dead or wedged peer strands this thread; pass "
                "timeout= and handle the expiry")


# ---------------------------------------------------------------------------
# VG013 — frame planning must stay pure/lazy
# ---------------------------------------------------------------------------
# The frame subsystem's contract (same spirit as VG004's pure property
# reads): compiling a logical plan builds LINEAGE — it must never compute
# a partition, materialize a device block, or issue a device transfer.
# Every materializing entry point lives in vega_tpu_torch/frame/api.py
# (the action surface); anywhere else in frame/, a call to the
# materializing surface is a plan-build-time side effect — explain() or a
# mere DataFrame construction would launch device work at unpredictable
# times, and pushdown decisions would silently become value probing.

_VG013_BANNED_CALLS = {
    "collect", "collect_arrays", "collect_columns", "collect_grouped",
    "compute", "iterator", "block", "block_spec", "to_numpy", "host_get",
    "device_get", "device_put", "run_job", "submit_job",
    # The RDD actions: `if node.count() > t:` at plan-build time IS the
    # value-probing class this rule exists for.
    "count", "take", "reduce",
}
# counts_np only: it is unique to Block (a device counts fetch), while
# e.g. "num_rows" also names innocent pyarrow metadata — conservative by
# design (a crying-wolf rule gets pragma'd into silence).
_VG013_BANNED_ATTRS = {"counts_np"}


@rule("VG013", "materializing call at frame plan-build time")
def vg013(ctx: FileCtx) -> Iterator[Finding]:
    if not ctx.in_dir(PKG, "frame") or ctx.endswith("frame/api.py"):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = _last_name(node.func)
            if name in _VG013_BANNED_CALLS:
                yield Finding(
                    "VG013", ctx.display, node.lineno, node.col_offset + 1,
                    f"'{name}()' inside frame planning code — plan "
                    "compilation must stay pure/lazy (no partition "
                    "compute, no device block reads); materializing "
                    "actions belong in vega_tpu_torch/frame/api.py")
        elif isinstance(node, ast.Attribute) \
                and node.attr in _VG013_BANNED_ATTRS \
                and isinstance(node.ctx, ast.Load):
            yield Finding(
                "VG013", ctx.display, node.lineno, node.col_offset + 1,
                f"'.{node.attr}' read inside frame planning code — that "
                "is a device materialization/transfer; planning must stay "
                "pure")


# ---------------------------------------------------------------------------
# VG014 — exchange implementations must keep the exchange contract
# ---------------------------------------------------------------------------
# CLAUDE.md: "Every new exchange implementation keeps the (cols, count,
# overflow) contract and the n_shards==1 passthrough." With the planner
# (exchange_plan.py) choosing among exchange programs per launch, a
# new implementation that forgets either half would corrupt results only
# on the meshes/budgets that happen to select it — exactly the class a
# machine check must hold. An exchange ENTRY POINT is a public function
# in the device tier whose name ends in `_exchange` and takes the canonical
# call shape's `bucket` and `n_shards` arguments — what the exchange
# sites in dense_rdd.py actually invoke (passthrough_exchange — the
# shared gate target, which has neither by design — private `_`-prefixed
# helpers, and non-implementation functions like the planner's
# plan_exchange are exempt by that signature test). Each must (a)
# contain the single-shard gate: an `if n_shards == 1:` branch returning
# a call to passthrough_exchange or a delegation to another *_exchange
# function, and (b) return the triple at every return site — a literal
# 3-tuple or such a delegation.


def _vg014_is_exchange_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _last_name(node.func)
    return name is not None and name.endswith("_exchange")


def _vg014_gate_ok(fn: ast.AST) -> bool:
    """An `if n_shards == 1:` whose body returns an exchange call."""
    for node in _own_nodes(fn):
        if not isinstance(node, ast.If):
            continue
        t = node.test
        if not (isinstance(t, ast.Compare) and len(t.ops) == 1
                and isinstance(t.ops[0], ast.Eq)):
            continue
        sides = (t.left, t.comparators[0])
        names = [s.id for s in sides if isinstance(s, ast.Name)]
        ones = [s for s in sides
                if isinstance(s, ast.Constant) and s.value == 1]
        if "n_shards" not in names or not ones:
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.Return) \
                    and _vg014_is_exchange_call(stmt.value):
                return True
    return False


@rule("VG014", "exchange entry point violates the exchange contract")
def vg014(ctx: FileCtx) -> Iterator[Finding]:
    if not in_device_tier(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, _FUNC_DEFS):
            continue
        name = node.name
        if not name.endswith("_exchange") or name.startswith("_") \
                or name == "passthrough_exchange":
            continue
        args = node.args
        arg_names = {a.arg for a in args.posonlyargs + args.args
                     + args.kwonlyargs}
        if "n_shards" not in arg_names or "bucket" not in arg_names:
            continue  # not the exchange call shape (e.g. the planner)
        if not _vg014_gate_ok(node):
            yield Finding(
                "VG014", ctx.display, node.lineno, node.col_offset + 1,
                f"exchange entry point '{name}' is missing the "
                "single-shard gate (`if n_shards == 1: return "
                "passthrough_exchange(...)`)" " — every exchange "
                "implementation must keep the n_shards==1 passthrough "
                "(CLAUDE.md)")
        for ret in _own_nodes(node):
            if not isinstance(ret, ast.Return):
                continue
            v = ret.value
            triple = isinstance(v, ast.Tuple) and len(v.elts) == 3
            if not triple and not _vg014_is_exchange_call(v):
                yield Finding(
                    "VG014", ctx.display, ret.lineno, ret.col_offset + 1,
                    f"return in exchange entry point '{name}' is neither "
                    "a (cols, count, overflow) 3-tuple nor a delegation "
                    "to another exchange — the exchange contract's "
                    "return shape (CLAUDE.md)")


# ---------------------------------------------------------------------------
# VG015 — streaming state mutations flow through the commit API
# ---------------------------------------------------------------------------
# The exactly-once guarantee lives in ONE place:
# streaming/state.py's StateStore.apply_batch, which orders merge ->
# checkpoint -> atomic commit record and dedups replayed batch ids. Any
# other streaming code writing state fields, minting CommitLogs, or
# checkpointing state directly would fork that ordering — a crash between
# its write and the commit record silently violates exactly-once on
# exactly the replay path chaos tests exist to protect. (The socket-
# timeout half rides VG012, whose directory index includes streaming/.)

_VG015_STATE_ATTRS = {"state", "_state", "last_committed_batch"}


@rule("VG015", "streaming state mutated outside the commit API")
def vg015(ctx: FileCtx) -> Iterator[Finding]:
    if not ctx.in_dir(PKG, "streaming") \
            or ctx.endswith("streaming/state.py"):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = _last_name(node.func)
            if name == "CommitLog":
                yield Finding(
                    "VG015", ctx.display, node.lineno, node.col_offset + 1,
                    "CommitLog minted outside streaming/state.py — commit "
                    "records must only be published by "
                    "StateStore.apply_batch, the one place that orders "
                    "merge -> checkpoint -> commit ")
            elif name == "write" and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "CheckpointRDD":
                yield Finding(
                    "VG015", ctx.display, node.lineno, node.col_offset + 1,
                    "CheckpointRDD.write of streaming state outside "
                    "streaming/state.py — state checkpoints must go "
                    "through StateStore.apply_batch so the atomic commit "
                    "record stays ordered after them ")
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                for sub in ast.walk(target):
                    if isinstance(sub, ast.Attribute) \
                            and sub.attr in _VG015_STATE_ATTRS:
                        yield Finding(
                            "VG015", ctx.display, sub.lineno,
                            sub.col_offset + 1,
                            f"direct write to streaming state "
                            f"('.{sub.attr}') outside streaming/state.py "
                            "— mutate state only via "
                            "StateStore.apply_batch (the exactly-once "
                            "commit API)")


# ---------------------------------------------------------------------------
# VG016–VG019 — thread-role dataflow rules over the project call graph
# ---------------------------------------------------------------------------
# Implementations (extraction, graph build, role propagation, checks)
# live in vega_tpu_torch/lint/callgraph.py — this block only registers them so
# importing `rules` populates the registry. VG016/VG019 are project
# rules sharing one cached per-file extraction (extract_key="callgraph",
# the VG009–VG012 contract-index shape); VG017/VG018 are self-contained
# per-file checks (capture and ship site, or acquire and release, are
# always in one function scope).

from vega_tpu_torch.lint import callgraph as _cg  # noqa: E402


@rule("VG016", "blocking op reachable from a latency-critical role",
      doc="Blocking operations (device_get/host_get round trips, "
          "Future.result()/queue.get()/join()/subprocess waits without "
          "timeout, settimeout(None)) reachable — through the project "
          "call graph — from the latency-critical roles (dag-loop, "
          "arbiter, elastic, reaper). A stall there parks scheduling or "
          "liveness detection for every tenant. Spawning a thread ends "
          "the role: offloading to Thread(target=...) is the sanctioned "
          "escape hatch.",
      project=True, extract=_cg.extract_callgraph, extract_key="callgraph")
def vg016(records) -> Iterator[Finding]:
    yield from _cg.check_vg016(records)


@rule("VG017", "driver-only state captured into executor-shipped closure")
def vg017(ctx: FileCtx) -> Iterator[Finding]:
    """Closures passed to RDD ship methods (map/filter/reduce_by_key/...)
    must not capture driver-resident control-plane state — Context/
    scheduler/backend handles, Env, locks, sockets, torch tensors.
    Shipping one fails at pickle time at best and runs against a stale
    stub at worst."""
    yield from _cg.check_vg017(ctx)


@rule("VG018", "socket/file acquired without release on every path")
def vg018(ctx: FileCtx) -> Iterator[Finding]:
    """In distributed//shuffle//streaming/, a socket or file bound to a
    local name must be released on EVERY path: `with`, contextlib.closing,
    or close in a finally. Returning/storing/passing the handle transfers
    ownership and is fine."""
    yield from _cg.check_vg018(ctx)


@rule("VG019", "driver-only function reachable from a confined role",
      doc="Functions in the driver-only seed set (Env mutation, context "
          "teardown, fleet mutation) or annotated "
          "`# vegalint: role[driver-only]` must not be reachable from "
          "the confined roles (worker-task, stream-receiver) in the "
          "project call graph — executor/ingest threads must never "
          "mutate driver state.",
      project=True, extract=_cg.extract_callgraph, extract_key="callgraph")
def vg019(records) -> Iterator[Finding]:
    yield from _cg.check_vg019(records)


def _vg020_is_object_dtype(node: ast.AST) -> bool:
    """True for the spellings that name the numpy object dtype: the
    `object` builtin, `np.object_`, and the 'O'/'object' dtype strings."""
    if isinstance(node, ast.Name) and node.id == "object":
        return True
    if isinstance(node, ast.Attribute) and node.attr in ("object_", "object"):
        return True
    if isinstance(node, ast.Constant) and node.value in ("O", "object"):
        return True
    return False


@rule("VG020", "object-dtype array created on a device-bound path")
def vg020(ctx: FileCtx) -> Iterator[Finding]:
    """Device-tier code (DEVICE_MODULES) must never CREATE object-dtype
    numpy arrays: torch has no tensor for them, so one reaching a shard
    program or device kernel dies with a raw TypeError mid-stage
    (block._check_dtype turns that into a crisp VegaError, but only at
    the block boundary — anything conjured past it is unguarded).
    Strings and Python objects cross the device boundary only as int32
    dictionary codes; dict_encoding.py is the one exempt file — it is
    the host-side encoder whose JOB is consuming such arrays to produce
    codes. Flags `dtype=object` / `dtype=np.object_` / `dtype="O"`
    keywords, the positional dtype of the common numpy constructors,
    `.astype(object)`-family calls, and `np.frompyfunc` (whose result is
    always an object array)."""
    if not in_device_tier(ctx):
        return
    if ctx.endswith(f"{PKG}/dict_encoding.py"):
        return
    ctors = {"array", "asarray", "empty", "zeros", "ones", "full",
             "fromiter", "frombuffer"}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _last_name(node.func)
        if name == "frompyfunc":
            yield Finding(
                "VG020", ctx.display, node.lineno, node.col_offset + 1,
                "np.frompyfunc always returns an object-dtype array — "
                "object arrays have no device representation; encode "
                "through dict_encoding.py instead")
            continue
        hit = None
        for kw in node.keywords:
            if kw.arg == "dtype" and _vg020_is_object_dtype(kw.value):
                hit = kw.value
        if hit is None and name == "astype" and node.args \
                and _vg020_is_object_dtype(node.args[0]):
            hit = node.args[0]
        # positional dtype: arg index 1 for array/asarray/empty/zeros/
        # ones/fromiter/frombuffer, 2 for full (arg 1 is the fill value)
        pos = 2 if name == "full" else 1
        if hit is None and name in ctors and len(node.args) > pos \
                and _vg020_is_object_dtype(node.args[pos]):
            hit = node.args[pos]
        if hit is not None:
            yield Finding(
                "VG020", ctx.display, node.lineno, node.col_offset + 1,
                "object-dtype array created in device-tier code — object "
                "arrays have no device representation (torch has no "
                "object dtype); strings/objects cross the boundary only "
                "as int32 dictionary codes (dict_encoding.py)")
