"""Frame logical -> physical compiler: the device lowering of
vega_tpu/frame/planner.py (its host lowering has no counterpart here).

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

The plans the reference compiles on its host tier because its device
tier refuses them run here on the device: joins with several value
columns a side, string comparisons (columns.DictCmp, codes resolved from
the dictionaries when the stage runs), min / max of a string column
beside other aggregates, wide int64 columns (columns.WideInt: exact
int64 arithmetic, a result outside int64 raises) and float32 group,
join and sort keys (-0.0 and 0.0 one key, each NaN its own). Where no
device form gives the host tier's rows (a stage that does not trace, a
source dtype with no device form, arithmetic or a sum over a string
column) the port raises VegaError carrying the reference's reason, when
the plan compiles: at explain(), collect() or count(), before any
device work.

Compilation is plan algebra, metadata reads and one probe of each stage
on empty CPU columns (dense_rdd._probe_cols): no source is read, no
block materialized and no chain applied until an action runs (api.py)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from vega_tpu_torch import block as block_lib
from vega_tpu_torch import dense_rdd as dr
from vega_tpu_torch import exchange_plan
from vega_tpu_torch import kernels
from vega_tpu_torch import mesh as mesh_lib
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame import columns as C
from vega_tpu_torch.frame import logical as L
from vega_tpu_torch.frame import parquet as parquet_lib
from vega_tpu_torch.frame import physical as P
from vega_tpu_torch.frame.expr import _AGG_MONOID, Col, Expr, Lit, evaluate
from vega_tpu_torch.frame.physical import no_device_lowering

DEFAULT_OPTIONS = {
    "fuse": True,        # whole-stage fusion (False: one chain per verb)
    "pushdown": True,    # column pruning + predicate pushdown into scans
    "tier": "auto",      # auto | device (the same here); host raises
    "exchange": None,    # exchange override (auto|all_to_all|ring|staged)
    "shuffle_plan": None,  # the host tier's shuffle plan: no effect here
}


class Compiled:
    """Physical plan handle: a lazy dense node plus what the action
    surface (api.py) needs to give frame-shaped results."""

    def __init__(self, rdd, cols: List[str], out: List[Tuple[str, str]],
                 limit: Optional[int], plan, notes: List[str],
                 float64=frozenset()):
        self.rdd = rdd
        self.cols = cols    # frame output columns, in order
        self.out = out      # (frame name, block name)
        # frame columns whose block pair holds float64 bits (_flush)
        self.float64 = frozenset(float64)
        self.limit = limit
        self.plan = plan
        self.notes = notes

    def explain(self) -> str:
        head = "== physical: device tier =="
        body = L.explain_tree(self.plan)
        notes = "".join(f"\n-- {n}" for n in self.notes)
        lim = f"\n-- limit {self.limit}" if self.limit is not None else ""
        return f"{head}\n{body}{notes}{lim}"


def compile_plan(ctx, plan: L.LogicalPlan, options: dict) -> Compiled:
    options = {**DEFAULT_OPTIONS, **(options or {})}
    if options["tier"] == "host":
        raise VegaError("tier='host' requested: vega_tpu_torch has no host "
                        "tier (the device tier serves every frame)")
    limit = None
    while isinstance(plan, L.Limit):
        limit = plan.n if limit is None else min(limit, plan.n)
        plan = plan.child
    opt = L.optimize(plan) if options["pushdown"] else plan
    notes: List[str] = []
    st = _lower_device(ctx, opt, options, notes)
    cols = opt.columns()
    if st.steps:
        taken: set = set()
        pairs = [(_sanitize(c, taken), Col(c)) for c in cols]
        node, f64 = _flush(st, pairs, bool(options["fuse"]))
        out = list(zip(cols, [bn for bn, _e in pairs]))
        float64 = {c for c, bn in out if bn in f64}
    else:
        node = st.node
        cm = dict(st.colmap)
        out = [(c, cm[c]) for c in cols]
        float64 = set(cols) & st.f64_cols
    return Compiled(node, cols, out, limit, opt, notes, float64)


# ---------------------------------------------------------------------------
# lowering helpers
# ---------------------------------------------------------------------------


def _sanitize(name: str, taken: set) -> str:
    """Frame name -> block column name: the canonical key name and the
    wide-int64 low-word suffix are reserved by the block layout."""
    bn = name
    if bn == "k" or bn.endswith(".lo") or not bn:
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


class _DState:
    """Device lowering cursor: the dense node built so far, the frame ->
    block column mapping, and the pending (not yet flushed) narrow steps
    of the current stage."""

    def __init__(self, node, colmap: List[Tuple[str, str]],
                 dict_cols=(), f64_cols=()):
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
        # (_flush): a float computed from a wide int64 column
        self.f64_cols = set(f64_cols)


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
    return no_device_lowering(
        f"{kind} over string column(s) {sorted(cols)} computes on "
        "dictionary codes; host tier evaluates it")


def _flush(st: _DState, out_pairs: List[Tuple[str, Expr]], fused: bool):
    """The pending stage plus the final projection as ONE dense pipeline
    node (or the node itself when that is an identity), and the output
    block columns that hold float64 bits. Comparisons of string columns
    become columns.DictCmp; raises VegaError when any other step computes
    over a string column or the stage does not run on column tensors.

    A float64 value computed from a wide int64 or a float64 column (a
    mean, a true division) stays float64, as the reference's host tier
    keeps a Python float: the (name, name.lo) words of its bits, through
    joins, sorts and aggregates (dense_rdd.reduce_columns' float64). As
    the exchange key "k" it raises, since float32 would merge keys the
    host keeps apart."""
    node = st.node
    in_schema = tuple(node._schema())
    in_names = [nm for nm, _ in in_schema]
    colmap = list(st.colmap)
    out_names = [bn for bn, _e in out_pairs]
    f64_in = {fn for fn, _bn in colmap if fn in st.f64_cols}
    if not st.steps:
        ident = dict(colmap)
        if out_names == [nm for nm in in_names
                         if not block_lib.is_lo(nm)] and all(
                isinstance(e, Col) and ident.get(e.name) == bn
                and not (e.name in f64_in and bn == "k")
                for bn, e in out_pairs):
            # pure passthrough: nothing to apply
            return node, {bn for bn, e in out_pairs if e.name in f64_in}
    # Dictionary (string) columns through the stage: codes PASS THROUGH
    # (bare Col) or are compared (DictCmp); any other expression over one
    # would compute on codes. `origin` tracks which parent block column
    # each live frame column passes through: a DictCmp reads that
    # column's dictionary, and the surviving passthroughs become the
    # pipeline's dict_renames, so Block.dicts follows the data.
    dict_live = set(st.dict_cols)
    origin = {fn: bn for fn, bn in colmap}
    cmps: List[C.DictCmp] = []
    steps = []
    for kind, payload in st.steps:
        if kind == "project":
            payload = [(nm, C.rewrite_string_cmps(e, dict_live, origin,
                                                  cmps))
                       for nm, e in payload]
            for _nm, e in payload:
                if not isinstance(e, Col) and \
                        C.computing_refs(e) & dict_live:
                    raise _string_error("expression",
                                        C.computing_refs(e) & dict_live)
            origin = {nm: (origin.get(e.name)
                           if isinstance(e, Col) else None)
                      for nm, e in payload}
            dict_live = {nm for nm, e in payload
                         if isinstance(e, Col) and e.name in dict_live}
        else:
            payload = C.rewrite_string_cmps(payload, dict_live, origin,
                                            cmps)
            if C.computing_refs(payload) & dict_live:
                raise _string_error("filter",
                                    C.computing_refs(payload) & dict_live)
        steps.append((kind, payload))
    dict_renames = {}
    pairs = []
    for bn, e in out_pairs:
        e = C.rewrite_string_cmps(e, dict_live, origin, cmps)
        if isinstance(e, Col):
            src = origin.get(e.name)
            if src is not None and e.name in dict_live:
                dict_renames[bn] = src
        elif C.computing_refs(e) & dict_live:
            raise _string_error("expression",
                                C.computing_refs(e) & dict_live)
        pairs.append((bn, e))
    # wide int64 input columns: (hi, lo) words -> C.WideInt values; the
    # float64 ones: the same words -> float64
    wide_in = {fn for fn, bn in colmap
               if block_lib.lo_of(bn) in in_names} - f64_in
    out_schema: tuple = ()  # set after the probe, which never reads it
    f64_out: set = set()  # output block columns of float64 bits (probe)
    memo: dict = {}  # the string comparisons' remap tables (columns.resolve)
    flagged: list = []  # [True] once the probe saw overflow flags recorded

    def stage(cols, count, dicts, probe: bool = False):
        """The steps, then, where the stage records overflow flags (the
        probe tells), one read of them on every rank: a wide value
        outside int64 on a valid row raises. Every rank reads, also one
        whose shards hold no row, since the read is a collective."""
        bad: list = []
        out, count = steps_over(cols, count, dicts, probe, bad)
        if probe:
            flagged[:] = [True] if bad else []
        elif flagged:
            flag = (torch.stack(bad).any() if bad else torch.zeros(
                (), dtype=torch.bool, device=cols[in_names[0]].device))
            if bool(np.asarray(mesh_lib.host_get(node.mesh, flag)).any()):
                raise VegaError(
                    "a frame expression over a wide int64 column left the "
                    "int64 range (or divided by zero) on a row: the "
                    "reference's host tier computes it on Python ints, "
                    "which the device cannot hold")
        return out, count

    def steps_over(cols, count, dicts, probe: bool, bad: list):
        """The steps over [n_shards, capacity] columns; bad gathers the
        overflow flags of the valid rows. Off the probe, on the CPU,
        padded rows take a valid row's values before each evaluation
        (dense_rdd._row_inputs), so no padding can raise (100 // 0); with
        no valid row on this rank the outputs are zeros."""
        like = cols[in_names[0]]
        cap = like.shape[1]
        env = {}
        for fn, bn in colmap:
            if fn in wide_in or fn in f64_in:
                v = kernels.wide_i64(cols[bn], cols[block_lib.lo_of(bn)])
                env[fn] = v.view(torch.float64) if fn in f64_in else v
            else:
                env[fn] = cols[bn]
        wide, f64 = set(wide_in), set(f64_in)

        def is_f64(x, e) -> bool:
            return (isinstance(x, torch.Tensor) and x.dtype == torch.float64
                    and bool(C.computing_refs(e) & (wide | f64)))
        resolved = C.resolve(cmps, dicts, like.device, memo)
        sink: list = []

        def inputs():
            ins = env if probe else dr._row_inputs(env, count)
            if ins is None:
                return None
            ins = {fn: C.WideInt(c, sink) if fn in wide else c
                   for fn, c in ins.items()}
            ins[C.RESOLVED] = resolved
            return ins

        def settle():
            # overflow flags of the rows valid at this step
            if sink:
                valid = kernels.valid_mask(cap, count)
                bad.extend((f & valid).any() for f in sink)
            sink.clear()

        for kind, payload in steps:
            ins = inputs()
            if ins is None:
                return dr._zero_cols(out_schema, like), count
            if kind == "project":
                vals = {nm: evaluate(e, ins) for nm, e in payload}
                settle()
                f64 = {nm for nm, e in payload if is_f64(vals[nm], e)}
                wide = {nm for nm, x in vals.items()
                        if isinstance(x, C.WideInt)}
                env = {nm: (x.v if nm in wide else x if nm in f64
                            else _column(x, like, nm))
                       for nm, x in vals.items()}
            else:
                keep = _column(evaluate(payload, ins), like, "filter")
                settle()
                keep = keep.to(torch.bool) & kernels.valid_mask(cap, count)
                env, count = kernels.compact(env, keep, cap)
        ins = inputs()
        if ins is None:
            return dr._zero_cols(out_schema, like), count
        out = {}
        for bn, e in pairs:
            x = evaluate(e, ins)
            if isinstance(x, C.WideInt):
                out[bn], out[block_lib.lo_of(bn)] = kernels.wide_words(x.v)
            elif is_f64(x, e):
                out[bn], out[block_lib.lo_of(bn)] = kernels.wide_words(
                    x.contiguous().view(torch.int64))
                if probe:
                    f64_out.add(bn)
            else:
                out[bn] = _column(x, like, bn).contiguous()
        settle()
        return out, count

    try:
        probe = dr._probe_cols(in_schema, node.n_shards)
        outs, _ = stage(probe, torch.zeros(node.n_shards, dtype=torch.int32),
                        {}, probe=True)
    except Exception as e:  # noqa: BLE001 — any probe failure: no lowering
        why = (str(e).split(dr.HOST_TIER_SUFFIX)[0]
               if isinstance(e, VegaError) else f"{type(e).__name__}: {e}")
        raise no_device_lowering(f"stage does not trace: {why}") from e
    if "k" in f64_out:
        raise no_device_lowering(
            "exchange key is a float64 computed from an int64 column; "
            "float32 would merge keys the host tier keeps apart")
    out_schema = tuple((bn, outs[bn].dtype) for bn in outs)
    token = ("frame_stage", tuple(colmap),
             tuple(_step_token(s) for s in steps),
             tuple((bn, e.token()) for bn, e in pairs))
    return dr.dense_pipeline(node, stage, out_schema, token, fused=fused,
                             dict_renames=dict_renames), f64_out


def _dicts_after(st: _DState, out_cols: List[str]) -> set:
    """Frame columns still dictionary-encoded AFTER the pending steps: a
    dict column survives a project only as a bare Col passthrough
    (anything else already raises in _flush), and filters never change
    column identity."""
    live = set(st.dict_cols)
    for kind, payload in st.steps:
        if kind == "project":
            live = {nm for nm, e in payload
                    if isinstance(e, Col) and e.name in live}
    return {c for c in out_cols if c in live}


def _check_key(node) -> None:
    """An exchange key the device orders and hashes: int32 (string codes
    too), float32 (-0.0 and 0.0 one key, each NaN its own) or a wide int64
    pair."""
    schema = dict(node._schema())
    dt = schema["k"]
    if dr.KEY_LO not in schema and dt not in (torch.int32, torch.float32):
        raise no_device_lowering(
            "device exchange key must be int32, float32 or int64, got "
            f"{str(dt).replace('torch.', '')}")


def _pick_exchange(ctx, options: dict, st: _DState, width: int,
                   notes: List[str]) -> Optional[str]:
    """Per-exchange program: an explicit hint wins; otherwise the launch
    follows the Context's dense_exchange. Under 'auto' the exchange
    planner's prediction at this exchange's estimated rows is noted when
    it is not the one-shot all_to_all (the launch plans again at its real
    capacities). Decided from source metadata, never by materializing."""
    if options["exchange"] is not None:
        return options["exchange"]
    if st.est_rows is None or ctx.dense_exchange != "auto":
        return None
    budget = ctx.dense_hbm_budget
    plan = exchange_plan.predict_for_rows(
        st.est_rows, 4 * max(width, 1), ctx.mesh.n_shards, budget)
    if plan.program != "all_to_all":
        notes.append(
            f"exchange=auto (planner predicts {plan.program}, est peak "
            f"{plan.est_peak_bytes >> 20} MiB vs budget "
            f"{budget >> 20} MiB)")
    return None


def _lower_device(ctx, plan: L.LogicalPlan, options: dict,
                  notes: List[str]) -> _DState:
    fused = bool(options["fuse"])
    if isinstance(plan, L.ColumnsScan):
        taken: set = set()
        names = [(fn, _sanitize(fn, taken)) for fn in plan.data]
        node = P.make_columns_source(ctx, plan.data, names)
        st = _DState(node, names, dict_cols=node._frame_dict_cols)
        st.est_rows = (len(next(iter(plan.data.values()))) if plan.data
                       else 0)
        return st
    if isinstance(plan, L.ParquetScan):
        cols = plan.columns()
        dtypes = parquet_lib.parquet_schema(plan.path)
        missing = [c for c in cols if c not in dtypes]
        if missing:
            raise VegaError(
                f"unknown column(s) {missing} — parquet file "
                f"{plan.path!r} has {sorted(dtypes)}")
        taken = set()
        names = [(fn, _sanitize(fn, taken)) for fn in cols]
        node = P.make_parquet_source(ctx, plan.path, cols, plan.predicate,
                                     names, dtypes)
        st = _DState(node, names, dict_cols=node._frame_dict_cols)
        st.est_rows = parquet_lib.parquet_num_rows(plan.path)
        return st
    if isinstance(plan, (L.Project, L.Filter)):
        st = _lower_device(ctx, plan.child, options, notes)
        st.steps.append(("project", list(plan.outputs))
                        if isinstance(plan, L.Project)
                        else ("filter", plan.predicate))
        if not fused:
            st = _unfused_break(st, plan.columns())
        return st
    if isinstance(plan, L.GroupAgg):
        return _lower_group_agg(ctx, plan, options, notes)
    if isinstance(plan, L.Join):
        return _lower_join(ctx, plan, options, notes)
    if isinstance(plan, L.Sort):
        st = _lower_device(ctx, plan.child, options, notes)
        others = [c for c in plan.columns() if c != plan.by]
        taken = {"k"}
        pairs = [("k", Col(plan.by))] + [
            (_sanitize(c, taken), Col(c)) for c in others]
        node, f64 = _flush(st, pairs, fused)
        _check_key(node)
        exchange = _pick_exchange(ctx, options, st, len(pairs), notes)
        sorted_node = node.sort_by_key(ascending=plan.ascending,
                                       exchange=exchange)
        notes.append("sort: device sample-sort exchange")
        out = _DState(sorted_node, [(plan.by, "k")] + list(
            zip(others, [bn for bn, _e in pairs[1:]])),
            dict_cols=_dicts_after(st, plan.columns()),
            f64_cols={c for c, (bn, _e) in zip(others, pairs[1:])
                      if bn in f64})
        out.est_rows = st.est_rows
        return out
    raise no_device_lowering(f"no device lowering for {type(plan).__name__}")


def _lower_group_agg(ctx, plan: L.GroupAgg, options: dict,
                     notes: List[str]) -> _DState:
    fused = bool(options["fuse"])
    st = _lower_device(ctx, plan.child, options, notes)
    specs, slots = _agg_specs(plan)
    live = _dicts_after(st, plan.child.columns())
    dict_specs = set()
    for bn, e, m in specs:
        if isinstance(e, Col) and e.name in live:
            # rank codes make min / max of a string column sound on the
            # device; every other monoid would fold dictionary codes
            if m not in ("min", "max"):
                raise no_device_lowering(
                    f"aggregate '{m}' over string column(s) "
                    f"{[e.name]} folds dictionary codes; host tier "
                    "aggregates it")
            dict_specs.add(bn)
    out_pairs = [("k", Col(plan.key))] + [(bn, e) for bn, e, _m in specs]
    staged, f64 = _flush(st, out_pairs, fused)
    _check_key(staged)
    exchange = _pick_exchange(ctx, options, st, len(specs) + 1, notes)
    ops = [m for _bn, _e, m in specs]
    red = dr.reduce_columns(staged, {bn: m for bn, _e, m in specs},
                            exchange=exchange, float64=f64)
    notes.append(f"groupBy: named-op '{ops[0]}' segment reduce"
                 if len(set(ops)) == 1
                 else f"groupBy: a named monoid per column {ops}")
    out = _DState(red, [(plan.key, "k")] + [
        (bn, bn) for bn, _e, _m in specs],
        dict_cols=(({plan.key} if plan.key in live else set())
                   | dict_specs),
        f64_cols={bn for bn, _e, _m in specs if bn in f64})
    out.est_rows = st.est_rows
    # mean finalization (and the companion drop) rides the NEXT stage
    proj = [(plan.key, Col(plan.key))]
    for a, slot in zip(plan.aggs, slots):
        if slot[0] == "mean":
            proj.append((a.alias, Col(specs[slot[1]][0])
                         / Col(specs[slot[2]][0])))
        else:
            proj.append((a.alias, Col(specs[slot[1]][0])))
    if any(s[0] == "mean" for s in slots) or any(
            a.alias != specs[s[1]][0] for a, s in zip(plan.aggs, slots)):
        out.steps.append(("project", proj))
        if not fused:
            out = _unfused_break(out, plan.columns())
    return out


def _lower_join(ctx, plan: L.Join, options: dict,
                notes: List[str]) -> _DState:
    """Both sides flushed to (k, their value columns) and joined in one
    frame_join; block names a<i> / b<i> keep the two sides' columns
    apart."""
    fused = bool(options["fuse"])
    lst = _lower_device(ctx, plan.left, options, notes)
    rst = _lower_device(ctx, plan.right, options, notes)
    lvals = [c for c in plan.left.columns() if c != plan.on]
    rvals = [c for c in plan.right.columns() if c != plan.on]
    lpairs = [("k", Col(plan.on))] + [
        (f"a{i}", Col(c)) for i, c in enumerate(lvals)]
    rpairs = [("k", Col(plan.on))] + [
        (f"b{i}", Col(c)) for i, c in enumerate(rvals)]
    lnode, lf64 = _flush(lst, lpairs, fused)
    rnode, rf64 = _flush(rst, rpairs, fused)
    _check_key(lnode)
    _check_key(rnode)
    exchange = _pick_exchange(ctx, options, lst, len(lpairs), notes)
    joined = dr.frame_join(lnode, rnode, outer=plan.how == "left",
                           fill_value=plan.fill_value, exchange=exchange,
                           float64=rf64)
    notes.append(f"join: device sort-merge ({plan.how})")
    llive = _dicts_after(lst, plan.left.columns())
    rlive = _dicts_after(rst, plan.right.columns())
    out = _DState(joined, [(plan.on, "k")]
                  + [(c, bn) for c, (bn, _e) in zip(lvals, lpairs[1:])]
                  + [(c, bn) for c, (bn, _e) in zip(rvals, rpairs[1:])],
                  dict_cols=(({plan.on} if plan.on in llive else set())
                             | (set(lvals) & llive) | (set(rvals) & rlive)),
                  f64_cols=(
                      {c for c, (bn, _e) in zip(lvals, lpairs[1:])
                       if bn in lf64}
                      | {c for c, (bn, _e) in zip(rvals, rpairs[1:])
                         if bn in rf64}))
    out.est_rows = lst.est_rows
    return out


def _unfused_break(st: _DState, cols: List[str]) -> _DState:
    """fuse=False: the pending step(s) as a pipeline of their own that
    materializes through its own chain, so every verb pays its own
    application (the fusion A/B's control leg)."""
    taken: set = set()
    pairs = [(_sanitize(c, taken), Col(c)) for c in cols]
    node, f64 = _flush(st, pairs, fused=False)
    out = _DState(node, list(zip(cols, [bn for bn, _e in pairs])),
                  dict_cols=_dicts_after(st, cols),
                  f64_cols={c for c, (bn, _e) in zip(cols, pairs)
                            if bn in f64})
    out.est_rows = st.est_rows
    return out
