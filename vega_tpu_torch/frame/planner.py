"""Frame logical -> physical compiler: the port's copy of
vega_tpu/frame/planner.py, with its two lowerings of one optimized plan.

Scans become lazy dense sources (pruned columns and pushed predicates
reach the parquet reader, so unneeded data never leaves the file); every
maximal run of select / filter / with_column / rename steps becomes ONE
`dense_rdd.dense_pipeline` node, which the next exchange applies inside
its own narrow chain (or which materializes on its own under
hint(fuse=False)); group_by().agg() lowers onto reduce_by_key with the
named op when one monoid covers every aggregate, else onto one reduce
with a named monoid per column (dense_rdd.reduce_columns; monoid
selection by aggregate NAME, never value probing); join lowers onto
dense_rdd.frame_join (every value column of both sides in one
sort-merge join) and sort onto sort_by_key, each with the exchange
program of hint(exchange=) or the Context's dense_exchange (the exchange
planner's prediction is noted in explain()).

The reference picks ONE tier per plan: its device lowering either takes
the whole plan or raises HostFallback somewhere, and its host tier runs
the whole plan. The two tiers hold bools, float64 and fill values apart.
reference_tier() is the port's copy of that decision (every HostFallback
site of the reference's device lowering, over the same optimized plan and
source dtypes; its stages traced under the reference's literal rule,
tracing.int32_literals, so a Python int past int32 sends the plan to the
host tier); the port runs every plan on its device tier and applies the
picked tier's rules:

* reference device tier: float64 narrows to float32 and bool widens to
  int32 at the source; a sum of a computed bool beside other monoids is
  a logical or (the reference's traced tuple combiner adds bools with
  jnp.add); a left join casts its fill to each right column's dtype.
* reference host tier (numpy columns and Python values): a float64
  source column stays float64 (the words of its bits) through stages,
  aggregates, joins and sorts; a bool stays a bool, and its sum counts
  the True rows; the stage arithmetic is numpy 2's (columns.host_binop:
  numpy's result dtype, float64 for an int beside a float or under /;
  before the first exchange an integer source of 32 bits or fewer
  computes in its own width and wraps (columns.NpInt), a Python int
  outside that width raising; an int64 source held as int32, and every
  int after an exchange (a Python int), computes exactly in int64, kept
  int32 only where the result provably fits); a count and a sum of
  bools or of an int32 column is a wide int64 and of a float32 one a
  float64; a mean of an integer column divides in float64; a bool key
  (a computed one, a string comparison) is an int32 0 / 1 exchange key
  given back as a bool; a float64 key is kernels.f64_key's
  order-preserving int64 (-0.0 and 0.0 one key, each NaN its own group,
  a NaN joins nothing), and a join key meeting one is the float64 Python
  compares it with; a left join's float fill makes an int32, wide or
  float32 right column float64 and an int fill past int32 makes an
  int32 one wide.

The plans the reference compiles on its host tier because its device
tier refuses them (joins with several value columns a side, string
comparisons, min / max of a string column beside other aggregates, wide
int64 columns, float group and join keys, bool keys) run here on the
device. Where no device form gives the host tier's rows (a stage that
does not trace, a source dtype with no device form, arithmetic or a sum
over a string column, a string fill over a number column, a left join
filling None) the device lowering raises physical.NoDeviceLowering and
the plan compiles on the host tier (_compile_host): the reference's host
lowering, copied, over the port's host RDD layer (vega_tpu_torch/rdd/):
columnar numpy blocks until the first exchange, row tuples after it.
hint(tier="host") compiles every plan there. A device plan that fails
when it runs raises; it is never run again on the host.
fallback_count() / last_fallback() count the reference's own decision
(reference_tier), so they read as the reference's do.

Compilation is plan algebra, metadata reads and one probe of each stage
on empty CPU columns (dense_rdd._probe_cols): no source is read, no
block materialized and no chain applied until an action runs (api.py)."""

from __future__ import annotations

import operator
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vega_tpu_torch import block as block_lib
from vega_tpu_torch import dense_rdd as dr
from vega_tpu_torch import exchange_plan
from vega_tpu_torch import kernels
from vega_tpu_torch import mesh as mesh_lib
from vega_tpu_torch import tracing
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame import columns as C
from vega_tpu_torch.frame import logical as L
from vega_tpu_torch.frame import parquet as parquet_lib
from vega_tpu_torch.frame import physical as P
from vega_tpu_torch.frame.expr import _AGG_MONOID, Col, Expr, Lit, evaluate
from vega_tpu_torch.frame.physical import NoDeviceLowering

DEFAULT_OPTIONS = {
    "fuse": True,        # whole-stage fusion (False: one chain per verb)
    "pushdown": True,    # column pruning + predicate pushdown into scans
    "tier": "auto",      # auto | device (raises where the reference
                         # would compile the host tier) | host
    "exchange": None,    # exchange override (auto|all_to_all|ring|staged)
    "shuffle_plan": None,  # the host tier's shuffle plan: one process
                           # here, so no effect
}

# The reference's device -> host fallbacks: every compile whose plan the
# reference's device lowering refuses (reference_tier) bumps the count and
# records why, whichever tier the port runs it on, so a test's deltas read
# the same on both packages.
_FALLBACKS = {"count": 0, "last": None}


def fallback_count() -> int:
    """Compiles in this process that the reference sends from its device
    tier to its host tier."""
    return _FALLBACKS["count"]


def last_fallback() -> Optional[str]:
    """The reference's reason for the most recent such compile."""
    return _FALLBACKS["last"]

# The companions of a float64 exchange key, as block and frame names: a
# group-by's wide column whose low bit is the sign of its first row's key
# (min of row order * 2 + sign), and a join's left or a sort's float64
# bits of each row's own key. _sanitize keeps user columns off "k~".
K_SIGN = "k~sign"
K_RAW = "k~raw"


class Compiled:
    """Physical plan handle: a lazy node (a dense node on the device tier,
    a host RDD on the host tier) plus what the action surface (api.py)
    needs to give frame-shaped results."""

    def __init__(self, rdd, cols: List[str], out: List[Tuple[str, str]],
                 limit: Optional[int], plan, notes: List[str],
                 float64=frozenset(), bools=frozenset(),
                 reference: Tuple[str, Optional[str]] = ("device", None),
                 kind: str = "device", layout: str = "block"):
        self.kind = kind    # "device" | "host": the tier that runs it
        self.rdd = rdd
        # device: "block"; host: "blocks" (numpy column dicts) | "rows"
        self.layout = layout
        self.cols = cols    # frame output columns, in order
        self.out = out      # (frame name, block name)
        # frame columns whose block pair holds float64 bits (_flush)
        self.float64 = frozenset(float64)
        # frame columns of 0 / 1 int32 words that are bools (a bool key)
        self.bools = frozenset(bools)
        # (tier, reason) the reference's compile_plan picks (reference_tier)
        self.reference = reference
        self.limit = limit
        self.plan = plan
        self.notes = notes

    def explain(self) -> str:
        head = f"== physical: {self.kind} tier =="
        body = L.explain_tree(self.plan)
        tier, why = self.reference
        ref = f"\n-- reference tier: {tier}" + (f" ({why})" if why else "")
        notes = "".join(f"\n-- {n}" for n in self.notes)
        lim = f"\n-- limit {self.limit}" if self.limit is not None else ""
        return f"{head}\n{body}{ref}{notes}{lim}"


def compile_plan(ctx, plan: L.LogicalPlan, options: dict) -> Compiled:
    options = {**DEFAULT_OPTIONS, **(options or {})}
    limit = None
    while isinstance(plan, L.Limit):
        limit = plan.n if limit is None else min(limit, plan.n)
        plan = plan.child
    opt = L.optimize(plan) if options["pushdown"] else plan
    tier = options["tier"]
    if tier == "host":
        return _compile_host(ctx, opt, limit,
                             ["host tier: requested via hint"],
                             ("host", "requested via hint"))
    sources = scan_sources(ctx, opt)
    reference = reference_tier(opt, sources, options)
    if reference[0] == "host":
        if tier == "device":
            # the reference's words: it raises where its device lowering
            # falls back
            raise VegaError("tier='device' requested but the plan has no "
                            f"device lowering: {reference[1]}")
        _FALLBACKS["count"] += 1
        _FALLBACKS["last"] = reference[1]
    try:
        return _compile_device(ctx, opt, options, limit, sources, reference)
    except NoDeviceLowering as e:
        if tier == "device":
            raise
        return _compile_host(ctx, opt, limit, [f"host tier: {e.reason}"],
                             reference)


def _compile_device(ctx, opt: L.LogicalPlan, options: dict,
                    limit: Optional[int], sources, reference) -> Compiled:
    lw = _Lowering(ctx, options, sources, reference[0] == "host")
    st = _lower(lw, opt)
    cols = opt.columns()
    if st.steps:
        taken: set = set()
        pairs = [(_sanitize(c, taken), Col(c)) for c in cols]
        f = _flush(lw, st, pairs)
        node = f.node
        out = list(zip(cols, [bn for bn, _e in pairs]))
        float64 = {c for c, bn in out if bn in f.f64}
        bools = {c for c, bn in out if bn in f.bools}
    else:
        node = st.node
        cm = dict(st.colmap)
        out = [(c, cm[c]) for c in cols]
        float64 = set(cols) & st.f64_cols
        bools = set(cols) & st.bool_cols
    return Compiled(node, cols, out, limit, opt, lw.notes, float64, bools,
                    reference)


def scan_sources(ctx, plan: L.LogicalPlan) -> Dict[int, P.ScanForms]:
    """{id(scan): its physical.ScanForms} of every scan of a plan: the
    column checks the tier decision and the sources share, once per
    compile."""
    out: Dict[int, P.ScanForms] = {}
    todo = [plan]
    while todo:
        node = todo.pop()
        todo.extend(node.children())
        if isinstance(node, L.ColumnsScan):
            out[id(node)] = P.columns_forms(node.data,
                                            ctx.dense_dict_enabled)
        elif isinstance(node, L.ParquetScan):
            cols = node.columns()
            dtypes = parquet_lib.parquet_schema(node.path)
            missing = [c for c in cols if c not in dtypes]
            if missing:
                raise VegaError(
                    f"unknown column(s) {missing} — parquet file "
                    f"{node.path!r} has {sorted(dtypes)}")
            out[id(node)] = P.parquet_forms(node.path, cols, node.predicate,
                                            dtypes, ctx.dense_dict_enabled)
    return out


# ---------------------------------------------------------------------------
# the reference's tier
# ---------------------------------------------------------------------------


class _RefHost(Exception):
    """A HostFallback of the reference's device lowering, in the copy."""


class _RefState:
    """The copy's cursor: each frame column's dtype on the reference's
    device tier, its dictionary (string) columns and pending steps."""

    def __init__(self, types: Dict[str, torch.dtype], dict_cols=()):
        self.types = dict(types)
        self.dict_cols = set(dict_cols)
        self.steps: List[tuple] = []


# a source column kind -> its dtype on the reference's device tier
_REF_DTYPES = {"int32": torch.int32, "bool": torch.int32,
               "dict": torch.int32, "float32": torch.float32,
               "float64": torch.float32}
# 64-bit results narrow on the reference's device tier (jax without x64)
_REF_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


def reference_tier(plan: L.LogicalPlan, sources: Dict[int, P.ScanForms],
                   options: dict) -> Tuple[str, Optional[str]]:
    """("device", None) or ("host", the reference's reason): the tier the
    reference's compile_plan picks for an optimized plan, before any
    block is built. A copy of every HostFallback site of its device
    lowering: a source column with no device form or beyond int32
    (sources: scan_sources'), a string stage or string aggregate, a
    stage that does not trace, an exchange key that is not int32 (a sort
    key: int32 or float32), a join side with more than one value column,
    a join its device tier degrades to the host path, and
    hint(tier="host"). A stage traces here on empty torch columns of the
    reference's device dtypes (int32, float32, bool), as the reference's
    jax.eval_shape does on abstract ones: a failure is its "stage does
    not trace". It is the reference's rule, not the port's probe, which
    sees the port's own forms."""
    if options.get("tier") == "host":
        return "host", "requested via hint"
    try:
        st = _ref_lower(plan, sources, bool(options.get("fuse", True)))
        if st.steps:
            _ref_flush(st, [(c, Col(c)) for c in plan.columns()])
    except _RefHost as e:
        return "host", str(e)
    return "device", None


def _refs(e: Expr) -> set:
    out: set = set()
    e.references(out)
    return out


def _ref_column(x) -> torch.Tensor:
    """One traced output as the reference's device tier types it: a
    tensor (64-bit narrowed), a Python constant with its weak type (int
    -> int32, float -> float32); anything else does not trace."""
    if isinstance(x, np.generic):
        x = torch.from_numpy(np.asarray(x))
    if isinstance(x, torch.Tensor):
        return x.to(_REF_NARROW.get(x.dtype, x.dtype))
    if isinstance(x, bool):
        return torch.zeros(0, dtype=torch.bool)
    if isinstance(x, int):
        if tracing.past_int32(x):
            raise OverflowError(f"Python int {x} is outside int32")
        return torch.zeros(0, dtype=torch.int32)
    if isinstance(x, float):
        return torch.zeros(0, dtype=torch.float32)
    raise TypeError(f"a stage output of type {type(x).__name__} is not an "
                    "array")


def _ref_string_error(kind: str, cols) -> _RefHost:
    verb = "compares" if kind == "filter" else "computes on"
    return _RefHost(f"{kind} over string column(s) {sorted(cols)} {verb} "
                    "dictionary codes; host tier evaluates it")


def _ref_flush(st: _RefState, out_pairs) -> Dict[str, torch.dtype]:
    """The reference's _flush: its string checks, then the stage traced
    under its literal rule (tracing.int32_literals: a Python int past
    int32 does not trace); the dtype of each output."""
    _string_steps(st.steps, out_pairs, st.dict_cols, {}, _refs,
                  _ref_string_error)

    def traced(e, env):
        with tracing.int32_literals():
            return _ref_column(evaluate(e, env))

    try:
        env = {fn: torch.zeros(0, dtype=dt) for fn, dt in st.types.items()}
        for kind, payload in st.steps:
            if kind == "project":
                env = {nm: traced(e, env) for nm, e in payload}
            else:
                traced(payload, env).to(torch.bool)
        return {bn: traced(e, env).dtype for bn, e in out_pairs}
    except Exception as e:  # noqa: BLE001 — any trace failure: host tier
        raise _RefHost(f"stage does not trace: {e}") from e


def _ref_key(dt: torch.dtype, allowed: Tuple[str, ...]) -> None:
    name = str(dt).replace("torch.", "")
    if name not in allowed:
        raise _RefHost(f"device exchange key must be {allowed}, got {name}")


def _ref_break(st: _RefState, cols: List[str]) -> _RefState:
    types = _ref_flush(st, [(c, Col(c)) for c in cols])
    return _RefState(types, _dicts_after(st, cols))


def _ref_lower(plan: L.LogicalPlan, sources, fused: bool) -> _RefState:
    if isinstance(plan, (L.ColumnsScan, L.ParquetScan)):
        forms = sources[id(plan)]
        if forms.reference:
            raise _RefHost(forms.reference)
        return _RefState({fn: _REF_DTYPES[k] for fn, k in forms.kinds.items()},
                         {fn for fn, k in forms.kinds.items() if k == "dict"})
    if isinstance(plan, (L.Project, L.Filter)):
        st = _ref_lower(plan.child, sources, fused)
        st.steps.append(("project", list(plan.outputs))
                        if isinstance(plan, L.Project)
                        else ("filter", plan.predicate))
        return st if fused else _ref_break(st, plan.columns())
    if isinstance(plan, L.GroupAgg):
        st = _ref_lower(plan.child, sources, fused)
        specs, slots = _agg_specs(plan)
        live = _dicts_after(st, plan.child.columns())
        ops = [m for _bn, _e, m in specs]
        dict_specs = set()
        for bn, e, m in specs:
            if _refs(e) & live:
                if m not in ("min", "max"):
                    raise _RefHost(
                        f"aggregate '{m}' over string column(s) "
                        f"{sorted(_refs(e) & live)} folds dictionary codes; "
                        "host tier aggregates it")
                if len(set(ops)) != 1:
                    raise _RefHost(
                        "mixed-op aggregation with a string column has no "
                        "device combiner; host tier aggregates it")
                dict_specs.add(bn)
        types = _ref_flush(st, [("k", Col(plan.key))]
                           + [(bn, e) for bn, e, _m in specs])
        _ref_key(types["k"], ("int32",))
        out = _RefState(
            dict([(plan.key, types["k"])]
                 + [(bn, types[bn]) for bn, _e, _m in specs]),
            ({plan.key} & live) | dict_specs)
        proj, renames = _agg_projection(plan, specs, slots)
        if renames:
            out.steps.append(("project", proj))
            if not fused:
                out = _ref_break(out, plan.columns())
        return out
    if isinstance(plan, L.Join):
        lst = _ref_lower(plan.left, sources, fused)
        rst = _ref_lower(plan.right, sources, fused)
        lvals = [c for c in plan.left.columns() if c != plan.on]
        rvals = [c for c in plan.right.columns() if c != plan.on]
        if len(lvals) != 1 or len(rvals) != 1:
            raise _RefHost(
                "device join needs exactly one value column per side "
                f"(have {lvals} x {rvals}); host tier joins the rest")
        lt = _ref_flush(lst, [("k", Col(plan.on)), ("v", Col(lvals[0]))])
        rt = _ref_flush(rst, [("k", Col(plan.on)), ("v", Col(rvals[0]))])
        _ref_key(lt["k"], ("int32",))
        _ref_key(rt["k"], ("int32",))
        llive = _dicts_after(lst, plan.left.columns())
        rlive = _dicts_after(rst, plan.right.columns())
        # the reference's join leaves its device tier (a host RDD) when one
        # key is dictionary codes and the other not (_align_keys), and a
        # left join when its fill is None or its right value is strings
        if (plan.on in llive) != (plan.on in rlive) or (
                plan.how == "left" and (plan.fill_value is None
                                        or rvals[0] in rlive)):
            raise _RefHost("join degraded to the host path")
        return _RefState(
            {plan.on: lt["k"], lvals[0]: lt["v"], rvals[0]: rt["v"]},
            ({plan.on} & llive) | ({lvals[0]} & llive)
            | ({rvals[0]} & rlive))
    if isinstance(plan, L.Sort):
        st = _ref_lower(plan.child, sources, fused)
        others = [c for c in plan.columns() if c != plan.by]
        types = _ref_flush(st, [("k", Col(plan.by))]
                           + [(c, Col(c)) for c in others])
        _ref_key(types["k"], ("int32", "float32"))
        types[plan.by] = types.pop("k")
        return _RefState(types, _dicts_after(st, plan.columns()))
    raise _RefHost(f"no device lowering for {type(plan).__name__}")


# ---------------------------------------------------------------------------
# lowering helpers
# ---------------------------------------------------------------------------


def _sanitize(name: str, taken: set) -> str:
    """Frame name -> block column name: the canonical key name, the
    wide-int64 low-word suffix and the float64 key's companions (k~) are
    reserved by the block layout."""
    bn = name
    if bn == "k" or bn.endswith(".lo") or not bn or bn.startswith("k~"):
        bn = "c_" + bn.replace(".", "_")
    while bn in taken:
        bn += "_"
    taken.add(bn)
    return bn


def _agg_specs(node: L.GroupAgg):
    """Normalize aggregates to (block_name, input Expr, monoid) triples
    plus finalize slots: count -> sum of ones, mean -> (sum, count) pair
    divided after the exchange. Monoids come from the aggregate NAME."""
    taken = {"k"}
    specs: List[tuple] = []   # (block_name, Expr, monoid)
    slots: List[tuple] = []   # ('v', i) | ('mean', i_sum, i_count)
    for a in node.aggs:
        if a.op == "count":
            specs.append((_sanitize(a.alias, taken), Lit(1), "add"))
            slots.append(("v", len(specs) - 1))
        elif a.op == "mean":
            specs.append((_sanitize(a.alias, taken), a.expr, "add"))
            i_sum = len(specs) - 1
            specs.append((_sanitize(a.alias + "__n", taken), Lit(1), "add"))
            slots.append(("mean", i_sum, len(specs) - 1))
        else:
            specs.append((_sanitize(a.alias, taken), a.expr,
                          _AGG_MONOID[a.op]))
            slots.append(("v", len(specs) - 1))
    return specs, slots


def _agg_projection(plan: L.GroupAgg, specs, slots, key=None,
                    f64_mean=frozenset()):
    """The stage after a group-by's reduce: the key (key: its expression,
    default the column), each aggregate under its alias and each mean
    divided (in float64 over a sum column named in f64_mean); and whether
    that stage does anything (a mean, a renamed aggregate, a key
    expression)."""
    proj = [(plan.key, key if key is not None else Col(plan.key))]
    for a, slot in zip(plan.aggs, slots):
        if slot[0] == "mean":
            s = specs[slot[1]][0]
            total = C.Cast(Col(s)) if s in f64_mean else Col(s)
            proj.append((a.alias, total / Col(specs[slot[2]][0])))
        else:
            proj.append((a.alias, Col(specs[slot[1]][0])))
    needed = key is not None or any(s[0] == "mean" for s in slots) or any(
        a.alias != specs[s[1]][0] for a, s in zip(plan.aggs, slots))
    return proj, needed


class _Lowering:
    """One compile's lowering context: the Context, the options, the
    explain() notes, the scans' forms and whether the reference compiles
    the plan on its host tier (its rules for bools, float64 and fills)."""

    def __init__(self, ctx, options: dict, sources, host: bool):
        self.ctx = ctx
        self.options = options
        self.fused = bool(options["fuse"])
        self.notes: List[str] = []
        self.sources = sources
        self.host = host


class _DState:
    """Device lowering cursor: the dense node built so far, the frame ->
    block column mapping, and the pending (not yet flushed) narrow steps
    of the current stage."""

    def __init__(self, node, colmap: List[Tuple[str, str]],
                 dict_cols=(), f64_cols=(), bool_cols=(), np_ints=None):
        self.node = node
        self.colmap = list(colmap)
        self.steps: List[tuple] = []
        self.est_rows: Optional[int] = None  # source row estimate
        # frame columns currently dictionary-encoded (string columns on
        # int32 codes): codes support equality / order / passthrough,
        # never arithmetic, so _flush refuses a computing expression over
        # one
        self.dict_cols = set(dict_cols)
        # frame columns of the node held as float64 bits in a word pair
        # (_flush): a float64 source column or a float computed from a
        # wide int64 or float64 one, where the reference's host tier
        # computes in Python floats
        self.f64_cols = set(f64_cols)
        # frame columns of the node on 0 / 1 int32 words that are bools:
        # a bool key, and a bool source column the host tier keeps
        self.bool_cols = set(bool_cols)
        # {frame column: numpy dtype} of the integer columns the host tier
        # holds in numpy's own width of 32 bits or fewer: a source column
        # and what a stage computes from it, up to the first exchange
        # (after it the host holds Python ints)
        self.np_ints = dict(np_ints or {})


class _Flushed(NamedTuple):
    """A flushed stage: the node, its output block columns of float64
    bits (f64) and of 0 / 1 int32 words standing for bools (bools),
    whether "k" holds kernels.f64_key's words of a float64 key (f64_key),
    with its companion K_SIGN or K_RAW, and {output block column: numpy
    dtype} of its numpy-width integer outputs (np_ints)."""
    node: dr.DenseRDD
    f64: frozenset
    bools: frozenset
    f64_key: bool
    np_ints: dict


def _step_token(step) -> tuple:
    kind, payload = step
    if kind == "project":
        return ("project", tuple((nm, e.token()) for nm, e in payload))
    return ("filter", payload.token())


def _column(x, like: torch.Tensor, what: str) -> torch.Tensor:
    """One evaluated expression as a column of like's [n_shards, capacity]
    shape, device and block dtype: a tensor of that shape keeps its dtype,
    a 0-d tensor broadcasts, a Python constant broadcasts with the
    reference's weak type (int -> int32, float -> float32, bool -> bool),
    and 64-bit dtypes narrow (dense_rdd._column_dtype, the row functions'
    rule)."""
    shape = tuple(like.shape[:2])
    if isinstance(x, torch.Tensor) and x.dim() == 0:
        x = x.to(like.device).expand(shape)
    dt = dr._column_dtype(x, shape, f"frame column {what!r}")
    return dr._as_column(x, dt, like)


def _string_error(kind: str, cols) -> VegaError:
    return NoDeviceLowering(
        f"{kind} over string column(s) {sorted(cols)} computes on "
        "dictionary codes; host tier evaluates it")


def _string_steps(steps, out_pairs, live, origin, refs, error,
                  rewrite=None):
    """The string checks of one stage, the port's and the reference's
    copy alike: live, the dictionary (string) columns at its input, which
    pass through a bare Col; any other expression or filter that refs()
    finds computing over one raises error(kind, columns). rewrite(e, live,
    origin), the port's, first turns comparisons of string columns into
    DictCmp. origin maps each live frame column to the block column it
    passes through. Returns the steps and out_pairs as rewritten, and the
    live columns and their origins after the steps."""
    out_steps = []
    for kind, payload in steps:
        if kind == "project":
            if rewrite is not None:
                payload = [(nm, rewrite(e, live, origin))
                           for nm, e in payload]
            for _nm, e in payload:
                if not isinstance(e, Col) and refs(e) & live:
                    raise error("expression", refs(e) & live)
            origin = {nm: (origin.get(e.name) if isinstance(e, Col)
                           else None) for nm, e in payload}
            live = {nm for nm, e in payload
                    if isinstance(e, Col) and e.name in live}
        else:
            if rewrite is not None:
                payload = rewrite(payload, live, origin)
            if refs(payload) & live:
                raise error("filter", refs(payload) & live)
        out_steps.append((kind, payload))
    pairs = []
    for bn, e in out_pairs:
        if rewrite is not None:
            e = rewrite(e, live, origin)
        if not isinstance(e, Col) and refs(e) & live:
            raise error("expression", refs(e) & live)
        pairs.append((bn, e))
    return out_steps, pairs, live, origin


def _row_order(node, like: torch.Tensor) -> torch.Tensor:
    """int64 [n_shards, capacity]: each row's place in the block's row
    order (global shard << 32 | row), unique in the block."""
    shards = torch.arange(like.shape[0], dtype=torch.int64,
                          device=like.device) + node.mesh.first_shard
    rows = torch.arange(like.shape[1], dtype=torch.int64, device=like.device)
    return (shards[:, None] << 32) | rows[None, :]


def _as_float64(x) -> torch.Tensor:
    """A key column as the float64 that Python compares it with: a float
    or an int32 or bool exactly; a wide int64 where a float64 holds it,
    else NaN (no float equals it, and f64_key's NaN joins nothing)."""
    if not isinstance(x, C.WideInt):
        return x.to(torch.float64)
    f = x.v.to(torch.float64)
    inside = (f >= -2.0**63) & (f < 2.0**63)
    exact = inside & (torch.where(inside, f, 0.0).to(torch.int64) == x.v)
    return torch.where(exact, f, torch.nan)


def _settled(x):
    """A numpy-width value (columns.NpInt) in its block form; any other
    value as it is."""
    return x.stored() if isinstance(x, C.NpInt) else x


def _cast(x, to: str, like: torch.Tensor):
    """One output in the wider form a host-tier rule picked: "float64" (a
    float32 sum; an int32, wide, float32 or bool column beside a float
    fill) or "wide" (a count, a sum of bools or of an int32 column; an
    int32 column beside an int fill past int32)."""
    x = x.v if isinstance(x, C.WideInt) else torch.as_tensor(x)
    if x.dim() == 0:
        x = x.to(like.device).expand(tuple(like.shape[:2]))
    if to == "wide":
        return C.WideInt(x.to(torch.int64), [])
    return x.to(torch.float64)


# the NaN side of kernels.f64_key for each exchange role
_KEY_SIDES = {"group": 0, "join_left": 0, "join_right": 1, "sort": None}


class _Stage:
    """The pending steps of a _DState and a final projection (out_pairs),
    checked and probed once on empty CPU columns: comparisons of string
    columns become columns.DictCmp, any other step that computes over a
    string column raises VegaError, and so does a stage that does not run
    on column tensors. In a plan the reference compiles on its host tier
    the arithmetic is its numpy's (columns.HostArith), and a float64 value
    (a float64 source column, a mean, a true division) stays float64, as
    the host holds it: the (name, name.lo) words of its bits, through
    joins, sorts and aggregates (dense_rdd.reduce_columns' float64).

    kinds gives the dtype of each output as the probe saw it: torch.int64
    for a wide int64 pair, torch.float64 for float64 bits, else the
    column's own. flush() then builds the node with the exchange key's
    form and the casts that the caller picked from kinds."""

    def __init__(self, lw: _Lowering, st: _DState,
                 out_pairs: List[Tuple[str, Expr]]):
        self.lw, self.st, self.out_pairs = lw, st, out_pairs
        node = st.node
        self.in_schema = tuple(node._schema())
        self.in_names = [nm for nm, _ in self.in_schema]
        self.f64_in = {fn for fn, _bn in st.colmap if fn in st.f64_cols}
        self.bool_in = {fn for fn, _bn in st.colmap if fn in st.bool_cols}
        self.wide_in = {fn for fn, bn in st.colmap
                        if block_lib.lo_of(bn) in self.in_names} - self.f64_in
        self.np_in = {fn: st.np_ints[fn] for fn, _bn in st.colmap
                      if fn in st.np_ints}
        # `origin` tracks which parent block column each live string
        # column passes through: a DictCmp reads that column's dictionary,
        # and the surviving passthroughs become the pipeline's
        # dict_renames, so Block.dicts follows the data
        self.cmps: List[C.DictCmp] = []
        steps, pairs, live, origin = _string_steps(
            st.steps, out_pairs, set(st.dict_cols), dict(st.colmap),
            C.computing_refs, _string_error,
            lambda e, lv, org: C.rewrite_string_cmps(e, lv, org, self.cmps))
        self.dict_renames = {bn: origin[e.name] for bn, e in pairs
                             if isinstance(e, Col) and e.name in live
                             and origin.get(e.name) is not None}
        if lw.host:
            steps = [(kind, [(nm, C.host_arith(e)) for nm, e in payload]
                      if kind == "project" else C.host_arith(payload))
                     for kind, payload in steps]
            pairs = [(bn, C.host_arith(e)) for bn, e in pairs]
        self.steps, self.pairs = steps, pairs
        self.memo: dict = {}  # the string comparisons' remap tables
        bad: list = []
        try:
            cols = dr._probe_cols(self.in_schema, node.n_shards)
            vals, _count, like = self._values(
                cols, torch.zeros(node.n_shards, dtype=torch.int32), {},
                True, bad)
            self.kinds = {bn: self._kind(x, like, bn)
                          for bn, x in vals.items()}
        except C.NumpyOverflow:
            raise
        except Exception as e:  # noqa: BLE001 — any probe failure
            why = (str(e).split(dr.HOST_TIER_SUFFIX)[0]
                   if isinstance(e, VegaError)
                   else f"{type(e).__name__}: {e}")
            raise NoDeviceLowering(f"stage does not trace: {why}") from e
        # whether the stage records overflow flags, read at each run
        self.flagged = bool(bad)
        self._probe = (vals, like)

    def _is_f64(self, x) -> bool:
        return (self.lw.host and isinstance(x, torch.Tensor)
                and x.dtype == torch.float64)

    def _kind(self, x, like, bn) -> torch.dtype:
        x = _settled(x)
        if isinstance(x, C.WideInt):
            return torch.int64
        if self._is_f64(x):
            return torch.float64
        return _column(x, like, bn).dtype

    def _values(self, cols, count, dicts, probe: bool, bad: list):
        """The steps and out_pairs over [n_shards, capacity] columns:
        ({block column: its value}, count, like), the values None when
        no shard holds a valid row; bad gathers the overflow flags of the
        valid rows. Off the probe, on the CPU, padded rows take a valid
        row's values before each evaluation (dense_rdd._row_inputs), so no
        padding can raise (100 // 0)."""
        like = cols[self.in_names[0]]
        cap = like.shape[1]
        env = {}
        for fn, bn in self.st.colmap:
            if fn in self.wide_in or fn in self.f64_in:
                v = kernels.wide_i64(cols[bn], cols[block_lib.lo_of(bn)])
                env[fn] = v.view(torch.float64) if fn in self.f64_in else v
            elif fn in self.bool_in:
                env[fn] = cols[bn] != 0
            else:
                env[fn] = cols[bn]
        # numpy-width columns (host tier, before the first exchange)
        npi = dict(self.np_in)
        wide = set(self.wide_in) - set(npi)
        resolved = C.resolve(self.cmps, dicts, like.device, self.memo)
        sink: list = []

        def inputs():
            ins = env if probe else dr._row_inputs(env, count)
            if ins is None:
                return None
            ins = {fn: C.WideInt(c, sink) if fn in wide
                   else C.NpInt(c, npi[fn]) if fn in npi else c
                   for fn, c in ins.items()}
            ins[C.RESOLVED] = resolved
            ins[C.SINK] = sink
            return ins

        def settle():
            # overflow flags of the rows valid at this step
            if sink:
                valid = kernels.valid_mask(cap, count)
                bad.extend((f & valid).any() for f in sink)
            sink.clear()

        for kind, payload in self.steps:
            ins = inputs()
            if ins is None:
                return None, count, like
            if kind == "project":
                vals = {nm: self._const(evaluate(e, ins), like, sink)
                        for nm, e in payload}
                settle()
                wide = {nm for nm, x in vals.items()
                        if isinstance(x, C.WideInt)}
                npi = {nm: x.dt for nm, x in vals.items()
                       if isinstance(x, C.NpInt)}
                env = {nm: (x.v if nm in wide or nm in npi
                            else x if self._is_f64(x)
                            else _column(x, like, nm))
                       for nm, x in vals.items()}
            else:
                keep = _column(_settled(evaluate(payload, ins)), like,
                               "filter")
                settle()
                keep = keep.to(torch.bool) & kernels.valid_mask(cap, count)
                env, count = kernels.compact(env, keep, cap)
        ins = inputs()
        if ins is None:
            return None, count, like
        vals = {bn: self._const(evaluate(e, ins), like, sink)
                for bn, e in self.pairs}
        settle()
        return vals, count, like

    def _const(self, x, like, sink):
        """A Python int output past int32 on the host tier: a WideInt
        column of it, as numpy broadcasts it (int64)."""
        if self.lw.host and tracing.past_int32(x):
            if not C.I64_MIN <= x <= C.I64_MAX:
                raise VegaError(f"constant {x} is outside int64")
            return C.WideInt(torch.full(tuple(like.shape[:2]), x,
                                        dtype=torch.int64,
                                        device=like.device), sink)
        return x

    def _key_words(self, x, like, out: dict, key: str, key_f64: bool,
                   seen: dict) -> bool:
        """The exchange key "k" of a bool or float64 column into out, and
        under key_f64 (the other join side's key is float64) of any key,
        as the float64 Python compares it with (_as_float64); False for
        any other key (an ordinary column)."""
        if not (self._is_f64(x) or key_f64):
            if isinstance(x, torch.Tensor) and x.dtype == torch.bool:
                out["k"] = x.to(torch.int32).contiguous()
                seen["bools"].add("k")
                return True
            return False
        raw = _as_float64(x).contiguous()
        order = _row_order(self.st.node, like)
        out["k"], out["k.lo"] = kernels.wide_words(
            kernels.f64_key(raw, order, _KEY_SIDES[key]))
        if key == "group":
            out[K_SIGN], out[block_lib.lo_of(K_SIGN)] = kernels.wide_words(
                order * 2 + torch.signbit(raw).to(torch.int64))
        elif key in ("join_left", "sort"):
            # the key as the left side holds it, which a join gives back
            if isinstance(x, C.WideInt):
                out[K_RAW], out[block_lib.lo_of(K_RAW)] = \
                    kernels.wide_words(x.v)
            elif x.dtype.is_floating_point:
                out[K_RAW], out[block_lib.lo_of(K_RAW)] = \
                    kernels.wide_words(raw.view(torch.int64))
                seen["f64"].add(K_RAW)
            else:
                out[K_RAW] = x.to(torch.int32).contiguous()
                if x.dtype == torch.bool:
                    seen["bools"].add(K_RAW)
        seen["f64_key"] = True
        return True

    def _finish(self, vals, like, key, key_f64, casts, seen) -> dict:
        """The evaluated outputs as block columns: the casts, the key's
        form, and wide values and float64 bits as word pairs."""
        out = {}
        for bn, x in vals.items():
            if isinstance(x, C.NpInt):
                seen["np_ints"][bn] = x.dt
            x = _settled(x)
            if bn in casts:
                x = _cast(x, casts[bn], like)
            if bn == "k" and key is not None and self._key_words(
                    x, like, out, key, key_f64, seen):
                continue
            if isinstance(x, C.WideInt):
                out[bn], out[block_lib.lo_of(bn)] = kernels.wide_words(x.v)
            elif self._is_f64(x):
                out[bn], out[block_lib.lo_of(bn)] = kernels.wide_words(
                    x.contiguous().view(torch.int64))
                seen["f64"].add(bn)
            else:
                out[bn] = _column(x, like, bn).contiguous()
        return out

    def flush(self, key: Optional[str] = None, key_f64: bool = False,
              casts: Optional[Dict[str, str]] = None,
              fused: Optional[bool] = None) -> _Flushed:
        """The stage as ONE dense pipeline node (or the node itself when
        that is an identity). key names the exchange the output "k" feeds
        ("group", "join_left", "join_right", "sort"): a bool key becomes
        int32 0 / 1, and a float64 one (any one under key_f64, to meet a
        float64 key) the wide words of kernels.f64_key, beside K_SIGN (a
        group-by) or K_RAW (a join's left side, a sort). casts: {output:
        _cast's form}."""
        lw, st, node = self.lw, self.st, self.st.node
        casts = dict(casts or {})
        fused = lw.fused if fused is None else fused
        ident = dict(st.colmap)
        if not st.steps and not casts and [
                bn for bn, _e in self.out_pairs] == [
                nm for nm in self.in_names if not block_lib.is_lo(nm)] \
                and all(isinstance(e, Col) and ident.get(e.name) == bn
                        and not (bn == "k" and key is not None
                                 and (e.name in self.f64_in or key_f64))
                        for bn, e in self.out_pairs):
            # pure passthrough: nothing to apply
            return _Flushed(
                node, frozenset(bn for bn, e in self.out_pairs
                                if e.name in self.f64_in),
                frozenset(bn for bn, e in self.out_pairs
                          if e.name in self.bool_in), False,
                {bn: self.np_in[e.name] for bn, e in self.out_pairs
                 if e.name in self.np_in})
        seen: dict = {"f64": set(), "bools": set(), "f64_key": False,
                      "np_ints": {}}
        vals, like = self._probe
        out_schema = tuple((bn, x.dtype) for bn, x in self._finish(
            vals, like, key, key_f64, casts, seen).items())

        def stage(cols, count, dicts):
            """The stage, then, where it records overflow flags (the probe
            tells), one read of them on every rank: a wide value outside
            int64 on a valid row raises. Every rank reads, also one whose
            shards hold no row, since the read is a collective."""
            bad: list = []
            vals, count, like = self._values(cols, count, dicts, False, bad)
            if self.flagged:
                flag = (torch.stack(bad).any() if bad else torch.zeros(
                    (), dtype=torch.bool, device=like.device))
                # vegalint: ignore[VG013] — inside the lowered stage callable: the read runs when the stage executes, not when the plan is compiled
                if bool(np.asarray(mesh_lib.host_get(node.mesh,
                                                     flag)).any()):
                    raise VegaError(
                        "a frame expression over a wide int64 column left "
                        "the int64 range (or divided by zero) on a row: "
                        "the reference's host tier computes it on Python "
                        "ints, which the device cannot hold")
            if vals is None:
                return dr._zero_cols(out_schema, like), count
            return self._finish(vals, like, key, key_f64, casts,
                                {"f64": set(), "bools": set(),
                                 "f64_key": False, "np_ints": {}}), count

        token = ("frame_stage", tuple(st.colmap),
                 tuple(_step_token(s) for s in self.steps),
                 tuple((bn, e.token()) for bn, e in self.pairs), key,
                 key_f64, tuple(sorted(casts.items())))
        node = dr.dense_pipeline(node, stage, out_schema, token, fused=fused,
                                 dict_renames=self.dict_renames)
        return _Flushed(node, frozenset(seen["f64"]),
                        frozenset(seen["bools"]), seen["f64_key"],
                        seen["np_ints"])


def _flush(lw: _Lowering, st: _DState, out_pairs: List[Tuple[str, Expr]],
           key: Optional[str] = None, fused: Optional[bool] = None
           ) -> _Flushed:
    """_Stage(lw, st, out_pairs).flush(key=key, fused=fused)."""
    return _Stage(lw, st, out_pairs).flush(key=key, fused=fused)


def _dicts_after(st, out_cols: List[str]) -> set:
    """Frame columns still dictionary-encoded AFTER the pending steps of
    a _DState or the reference's _RefState: a dict column survives a
    project only as a bare Col passthrough (anything else already raises
    in _string_steps), and filters never change column identity."""
    live = set(st.dict_cols)
    for kind, payload in st.steps:
        if kind == "project":
            live = {nm for nm, e in payload
                    if isinstance(e, Col) and e.name in live}
    return {c for c in out_cols if c in live}


def _check_key(node) -> None:
    """An exchange key the device orders and hashes: int32 (string codes
    and a bool key's 0 / 1 words too), float32 (-0.0 and 0.0 one key,
    each NaN its own) or a wide int64 pair (a float64 key's f64_key words
    too). _flush gives every other key one of these forms."""
    schema = dict(node._schema())
    dt = schema["k"]
    if dr.KEY_LO not in schema and dt not in (torch.int32, torch.float32):
        raise NoDeviceLowering(
            "device exchange key must be int32, float32 or int64, got "
            f"{str(dt).replace('torch.', '')}")


def _pick_exchange(lw: _Lowering, st: _DState, width: int) -> Optional[str]:
    """Per-exchange program: an explicit hint wins; otherwise the launch
    follows the Context's dense_exchange. Under 'auto' the exchange
    planner's prediction at this exchange's estimated rows is noted when
    it is not the one-shot all_to_all (the launch plans again at its real
    capacities). Decided from source metadata, never by materializing."""
    ctx = lw.ctx
    if lw.options["exchange"] is not None:
        return lw.options["exchange"]
    if st.est_rows is None or ctx.dense_exchange != "auto":
        return None
    budget = ctx.dense_hbm_budget
    plan = exchange_plan.predict_for_rows(
        st.est_rows, 4 * max(width, 1), ctx.mesh.n_shards, budget)
    if plan.program != "all_to_all":
        lw.notes.append(
            f"exchange=auto (planner predicts {plan.program}, est peak "
            f"{plan.est_peak_bytes >> 20} MiB vs budget "
            f"{budget >> 20} MiB)")
    return None


def _source_state(node, names, est_rows) -> _DState:
    st = _DState(node, names, dict_cols=node._frame_dict_cols,
                 f64_cols=node._frame_f64_cols,
                 bool_cols=node._frame_bool_cols,
                 np_ints=node._frame_np_ints)
    st.est_rows = est_rows
    return st


def _lower(lw: _Lowering, plan: L.LogicalPlan) -> _DState:
    ctx = lw.ctx
    if isinstance(plan, L.ColumnsScan):
        taken: set = set()
        names = [(fn, _sanitize(fn, taken)) for fn in plan.data]
        node = P.make_columns_source(ctx, plan.data, names,
                                     lw.sources[id(plan)], lw.host)
        return _source_state(node, names, (
            len(next(iter(plan.data.values()))) if plan.data else 0))
    if isinstance(plan, L.ParquetScan):
        cols = plan.columns()
        forms = lw.sources[id(plan)]
        taken = set()
        names = [(fn, _sanitize(fn, taken)) for fn in cols]
        node = P.make_parquet_source(ctx, plan.path, cols, plan.predicate,
                                     names, forms.file_dtypes, forms,
                                     lw.host)
        return _source_state(node, names,
                             parquet_lib.parquet_num_rows(plan.path))
    if isinstance(plan, (L.Project, L.Filter)):
        st = _lower(lw, plan.child)
        st.steps.append(("project", list(plan.outputs))
                        if isinstance(plan, L.Project)
                        else ("filter", plan.predicate))
        if not lw.fused:
            st = _unfused_break(lw, st, plan.columns())
        return st
    if isinstance(plan, L.GroupAgg):
        return _lower_group_agg(lw, plan)
    if isinstance(plan, L.Join):
        return _lower_join(lw, plan)
    if isinstance(plan, L.Sort):
        st = _lower(lw, plan.child)
        others = [c for c in plan.columns() if c != plan.by]
        taken = {"k"}
        pairs = [("k", Col(plan.by))] + [
            (_sanitize(c, taken), Col(c)) for c in others]
        f = _flush(lw, st, pairs, key="sort")
        _check_key(f.node)
        exchange = _pick_exchange(lw, st, len(pairs))
        sorted_node = f.node.sort_by_key(ascending=plan.ascending,
                                         exchange=exchange)
        lw.notes.append("sort: device sample-sort exchange")
        out = _DState(sorted_node, [(plan.by, K_RAW if f.f64_key else "k")]
                      + list(zip(others, [bn for bn, _e in pairs[1:]])),
                      dict_cols=_dicts_after(st, plan.columns()),
                      f64_cols={c for c, (bn, _e) in zip(others, pairs[1:])
                                if bn in f.f64} | (
                                    {plan.by} if f.f64_key else set()),
                      bool_cols={c for c, (bn, _e) in zip(others, pairs[1:])
                                 if bn in f.bools} | (
                                     {plan.by} if "k" in f.bools else set()))
        out.est_rows = st.est_rows
        return out
    raise NoDeviceLowering(f"no device lowering for {type(plan).__name__}")


def _lower_group_agg(lw: _Lowering, plan: L.GroupAgg) -> _DState:
    st = _lower(lw, plan.child)
    specs, slots = _agg_specs(plan)
    live = _dicts_after(st, plan.child.columns())
    dict_specs = set()
    for bn, e, m in specs:
        if isinstance(e, Col) and e.name in live:
            # rank codes make min / max of a string column sound on the
            # device; every other monoid would fold dictionary codes
            if m not in ("min", "max"):
                raise NoDeviceLowering(
                    f"aggregate '{m}' over string column(s) "
                    f"{[e.name]} folds dictionary codes; host tier "
                    "aggregates it")
            dict_specs.add(bn)
    stage = _Stage(lw, st, [("k", Col(plan.key))]
                   + [(bn, e) for bn, e, _m in specs])
    names = [m for _bn, _e, m in specs]
    ops = {bn: m for bn, _e, m in specs}
    adds = {bn: stage.kinds[bn] for bn, e, m in specs
            if m == "add" and not isinstance(e, Lit)}
    bool_adds = [bn for bn, dt in adds.items() if dt == torch.bool]
    casts = {}
    if lw.host:
        # the host tier sums Python values: each True counts one, and the
        # sum of bools or of an int32 column is an int (a wide int64
        # here), of a float32 column a float (float64); a count is an int
        # too (a mean's own count stays int32: it only divides)
        forms = {torch.bool: "wide", torch.int32: "wide",
                 torch.float32: "float64"}
        casts = {bn: forms[dt] for bn, dt in adds.items() if dt in forms}
        casts.update({specs[slot[1]][0]: "wide" for a, slot in zip(
            plan.aggs, slots) if a.op == "count"})
    elif bool_adds and len(set(names)) > 1:
        # the reference's traced tuple combiner adds bools with jnp.add, a
        # logical or (F8's rule), which max of bools is; a sum over bools
        # that is every aggregate's monoid stays add, which both refuse
        ops.update({bn: "max" for bn in bool_adds})
    f = stage.flush(key="group", casts=casts)
    _check_key(f.node)
    if f.f64_key:
        ops[K_SIGN] = "min"
    exchange = _pick_exchange(lw, st, len(specs) + 1)
    red = dr.reduce_columns(f.node, ops, exchange=exchange, float64=f.f64)
    lw.notes.append(f"groupBy: named-op '{names[0]}' segment reduce"
                    if len(set(names)) == 1
                    else f"groupBy: a named monoid per column {names}")
    out = _DState(red, [(plan.key, "k")] + [
        (bn, bn) for bn, _e, _m in specs] + (
            [(K_SIGN, K_SIGN)] if f.f64_key else []),
        dict_cols=(({plan.key} if plan.key in live else set())
                   | dict_specs),
        f64_cols={bn for bn, _e, _m in specs if bn in f.f64},
        bool_cols={plan.key} if "k" in f.bools else ())
    out.est_rows = st.est_rows
    # the host tier divides a mean's exact integer sum in Python floats
    rschema = dict(red._schema())
    f64_mean = {bn for bn, dt in rschema.items() if lw.host
                and dt == torch.int32 and bn not in dict_specs
                and block_lib.lo_of(bn) not in rschema}
    # mean finalization, the key's float64 and the companion drop ride
    # the NEXT stage
    proj, needed = _agg_projection(
        plan, specs, slots,
        key=C.KeyFloat64(Col(plan.key), Col(K_SIGN)) if f.f64_key else None,
        f64_mean=f64_mean)
    if needed:
        out.steps.append(("project", proj))
        if not lw.fused:
            out = _unfused_break(lw, out, plan.columns())
    return out


def _host_fill_casts(kinds: Dict[str, torch.dtype], rvals: List[str], fill,
                     strings: set) -> Dict[str, str]:
    """{right block column: _cast's form} that a left join's fill needs
    on the reference's host tier, whose rows keep the fill's Python type
    (kinds: the right stage's _Stage.kinds): a float fill makes an int32,
    wide, float32 or bool column float64 (its values exact), an int fill
    past int32 makes an int32 one wide and an int fill float32 cannot
    hold makes a float32 one float64. A string fill over a number column
    raises: the host mixes str and numbers in one column, which no
    device column holds. strings: the right string columns (they take
    str(fill), as on the device tier)."""
    casts = {}
    for i, c in enumerate(rvals):
        bn = f"b{i}"
        if c in strings:
            continue
        if isinstance(fill, str):
            raise NoDeviceLowering(f"a left join's string fill {fill!r} "
                                   f"over the number column {c!r}")
        dt = kinds[bn]
        if dt == torch.float64:
            continue
        if isinstance(fill, (float, np.floating)):
            casts[bn] = "float64"
        elif isinstance(fill, (int, np.integer)) and dt != torch.int64:
            v = int(fill)
            if dt == torch.float32:
                if float(np.float32(v)) != v:
                    casts[bn] = "float64"
            elif not kernels.INT32_MIN <= v <= kernels.INT32_MAX:
                casts[bn] = "wide"
    return casts


def _lower_join(lw: _Lowering, plan: L.Join) -> _DState:
    """Both sides flushed to (k, their value columns) and joined in one
    frame_join; block names a<i> / b<i> keep the two sides' columns
    apart. A float64 key on either side makes both sides' keys the
    float64 that Python compares them with (an int32, bool or float32 key
    exactly, a wide one where a float64 holds it): the host tier matches
    1 with 1.0. The left key keeps its own form, which the join gives
    back."""
    lst = _lower(lw, plan.left)
    rst = _lower(lw, plan.right)
    lvals = [c for c in plan.left.columns() if c != plan.on]
    rvals = [c for c in plan.right.columns() if c != plan.on]
    lpairs = [("k", Col(plan.on))] + [
        (f"a{i}", Col(c)) for i, c in enumerate(lvals)]
    rpairs = [("k", Col(plan.on))] + [
        (f"b{i}", Col(c)) for i, c in enumerate(rvals)]
    ls, rs = _Stage(lw, lst, lpairs), _Stage(lw, rst, rpairs)
    llive = _dicts_after(lst, plan.left.columns())
    rlive = _dicts_after(rst, plan.right.columns())
    key_f64 = torch.float64 in (ls.kinds["k"], rs.kinds["k"])
    if key_f64 and (plan.on in llive or plan.on in rlive):
        raise NoDeviceLowering(f"a join of a string key with a float64 "
                               f"key on {plan.on!r}")
    casts = {}
    if lw.host and plan.how == "left":
        casts = _host_fill_casts(rs.kinds, rvals, plan.fill_value,
                                 set(rvals) & rlive)
    lf = ls.flush(key="join_left", key_f64=key_f64)
    rf = rs.flush(key="join_right", key_f64=key_f64, casts=casts)
    _check_key(lf.node)
    _check_key(rf.node)
    exchange = _pick_exchange(lw, lst, len(lpairs))
    try:
        joined = dr.frame_join(lf.node, rf.node, outer=plan.how == "left",
                               fill_value=plan.fill_value, exchange=exchange,
                               float64=rf.f64)
    except dr._NotTraceable as e:
        raise NoDeviceLowering(str(e)) from e
    lw.notes.append(f"join: device sort-merge ({plan.how})")
    lkey = K_RAW if lf.f64_key else "k"
    out = _DState(joined, [(plan.on, lkey)]
                  + [(c, bn) for c, (bn, _e) in zip(lvals, lpairs[1:])]
                  + [(c, bn) for c, (bn, _e) in zip(rvals, rpairs[1:])],
                  dict_cols=(({plan.on} if plan.on in llive else set())
                             | (set(lvals) & llive) | (set(rvals) & rlive)),
                  f64_cols=(
                      {c for c, (bn, _e) in zip(lvals, lpairs[1:])
                       if bn in lf.f64}
                      | {c for c, (bn, _e) in zip(rvals, rpairs[1:])
                         if bn in rf.f64}
                      | ({plan.on} if lkey in lf.f64 else set())),
                  bool_cols={plan.on} if lkey in lf.bools else ())
    out.est_rows = lst.est_rows
    return out


def _unfused_break(lw: _Lowering, st: _DState, cols: List[str]) -> _DState:
    """fuse=False: the pending step(s) as a pipeline of their own that
    materializes through its own chain, so every verb pays its own
    application (the fusion A/B's control leg)."""
    taken: set = set()
    pairs = [(_sanitize(c, taken), Col(c)) for c in cols]
    f = _flush(lw, st, pairs, fused=False)
    out = _DState(f.node, list(zip(cols, [bn for bn, _e in pairs])),
                  dict_cols=_dicts_after(st, cols),
                  f64_cols={c for c, (bn, _e) in zip(cols, pairs)
                            if bn in f.f64},
                  bool_cols={c for c, (bn, _e) in zip(cols, pairs)
                             if bn in f.bools},
                  np_ints={c: f.np_ints[bn] for c, (bn, _e) in zip(
                      cols, pairs) if bn in f.np_ints})
    out.est_rows = st.est_rows
    return out


# ---------------------------------------------------------------------------
# host lowering (the reference's, over the port's host RDD layer)
# ---------------------------------------------------------------------------


class _HState:
    def __init__(self, rdd, layout: str, cols: List[str]):
        self.rdd = rdd
        self.layout = layout  # "blocks" | "rows"
        self.cols = list(cols)
        self.input_cols = list(cols)
        self.steps: List[tuple] = []  # pending, blocks layout only


def _host_flush_blocks(st: _HState) -> _HState:
    if not st.steps:
        return st
    emit = [(c, Col(c)) for c in st.cols]
    fn = P.host_block_stage([(c, c) for c in st.input_cols], st.steps, emit)
    return _HState(st.rdd.map(fn), "blocks", st.cols)


def _host_to_rows(st: _HState) -> _HState:
    st = _host_flush_blocks(st)
    if st.layout == "rows":
        return st
    return _HState(st.rdd.flat_map(P.host_block_rows(st.cols)), "rows",
                   st.cols)


def _lower_host(ctx, plan: L.LogicalPlan) -> _HState:
    if isinstance(plan, L.ColumnsScan):
        data = {nm: np.asarray(c) for nm, c in plan.data.items()}
        cols = list(data)
        n = len(data[cols[0]]) if cols else 0
        parts = plan.num_partitions or ctx.default_parallelism
        per = -(-n // parts) if n else 1
        chunks = [{nm: c[i * per:(i + 1) * per] for nm, c in data.items()}
                  for i in range(max(1, -(-n // per) if n else 1))]
        return _HState(ctx.parallelize(chunks, len(chunks)), "blocks", cols)
    if isinstance(plan, L.ParquetScan):
        cols = plan.columns()
        rdd = P.host_parquet_source(
            ctx, plan.path, None if plan.columns_kept is None else cols,
            plan.predicate, plan.num_partitions or ctx.default_parallelism)
        return _HState(rdd, "blocks", cols)
    if isinstance(plan, L.Project):
        st = _lower_host(ctx, plan.child)
        if st.layout == "blocks":
            st.steps.append(("project", list(plan.outputs)))
            st.cols = plan.columns()
            return st
        fn = P.host_rows_stage(st.cols, [], list(plan.outputs))
        return _HState(st.rdd.map(fn), "rows", plan.columns())
    if isinstance(plan, L.Filter):
        st = _lower_host(ctx, plan.child)
        if st.layout == "blocks":
            st.steps.append(("filter", plan.predicate))
            return st
        return _HState(
            st.rdd.filter(P.host_rows_filter(st.cols, plan.predicate)),
            "rows", st.cols)
    if isinstance(plan, L.GroupAgg):
        st = _lower_host(ctx, plan.child)
        specs, slots = _agg_specs(plan)
        spec_pairs = [(bn, e) for bn, e, _m in specs]
        ops = [m for _bn, _e, m in specs]
        # a single add / min / max shuffles bare scalars with the monoid
        # callable, as the reference's (the shuffle merges them natively)
        scalar = len(specs) == 1 and ops[0] in ("add", "min", "max")
        if st.layout == "blocks":
            st = _host_flush_blocks(st)
            pairs = st.rdd.flat_map(
                P.host_block_to_pairs(plan.key, spec_pairs, scalar=scalar))
        else:
            pairs = st.rdd.map(P.host_rows_to_pairs(
                st.cols, plan.key, spec_pairs, scalar=scalar))
        if scalar:
            monoid = {"add": operator.add, "min": min, "max": max}[ops[0]]
            rows = pairs.reduce_by_key(monoid).map(P.host_pair_to_row())
        else:
            reduced = pairs.reduce_by_key(P.host_tuple_combiner(ops))
            rows = reduced.map(P.host_finalize_slots(slots))
        return _HState(rows, "rows", plan.columns())
    if isinstance(plan, L.Join):
        lst = _host_to_rows(_lower_host(ctx, plan.left))
        rst = _host_to_rows(_lower_host(ctx, plan.right))
        lp = lst.rdd.map(P.host_row_to_pair(lst.cols.index(plan.on)))
        rp = rst.rdd.map(P.host_row_to_pair(rst.cols.index(plan.on)))
        if plan.how == "inner":
            rows = lp.join(rp).map(P.host_join_rows())
        else:
            rows = lp.cogroup(rp).flat_map(
                P.host_left_join_emit(len(rst.cols) - 1, plan.fill_value))
        return _HState(rows, "rows", plan.columns())
    if isinstance(plan, L.Sort):
        st = _host_to_rows(_lower_host(ctx, plan.child))
        rows = st.rdd.sort_by(_row_key(st.cols.index(plan.by)),
                              ascending=plan.ascending)
        return _HState(rows, "rows", st.cols)
    raise VegaError(f"no host lowering for {type(plan).__name__}")


def _row_key(idx: int):
    def key(row):
        return row[idx]

    return key


def _compile_host(ctx, plan: L.LogicalPlan, limit: Optional[int],
                  notes: List[str], reference) -> Compiled:
    st = _host_flush_blocks(_lower_host(ctx, plan))
    cols = plan.columns()
    return Compiled(st.rdd, cols, [(c, c) for c in cols], limit, plan,
                    notes, reference=reference, kind="host",
                    layout=st.layout)
