"""Frame logical -> physical compiler: the device lowering of
vega_tpu/frame/planner.py (its host lowering has no counterpart here).

Scans become lazy dense sources (pruned columns and pushed predicates
reach the parquet reader, so unneeded data never leaves the file); every
maximal run of select / filter / with_column / rename steps becomes ONE
`dense_rdd.dense_pipeline` node, which the next exchange applies inside
its own narrow chain (or which materializes on its own under
hint(fuse=False)); group_by().agg() lowers onto reduce_by_key with the
named op when one monoid covers every aggregate, else onto a traced tuple
combiner (monoid selection by aggregate NAME, never value probing);
join lowers onto join / left_outer_join and sort onto sort_by_key, each
with the exchange program of hint(exchange=) or the Context's
dense_exchange (the exchange planner's prediction is noted in explain()).

Where the reference falls back to its host tier (a stage that does not
trace, a source dtype with no device form, a computing expression over
a string column, a join with more than one value column a side, a key
dtype the exchange refuses) the port raises VegaError carrying the
reference's reason, when the plan compiles: at explain(), collect() or
count(), before any device work.

Compilation is plan algebra, metadata reads and one probe of each stage
on empty CPU columns (dense_rdd._probe_cols): no source is read, no
block materialized and no chain applied until an action runs (api.py)."""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from vega_tpu_torch import dense_rdd as dr
from vega_tpu_torch import exchange_plan
from vega_tpu_torch import kernels
from vega_tpu_torch.errors import VegaError
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
                 limit: Optional[int], plan, notes: List[str]):
        self.rdd = rdd
        self.cols = cols    # frame output columns, in order
        self.out = out      # (frame name, block name)
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
        node = _flush(st, pairs, bool(options["fuse"]))
        out = list(zip(cols, [bn for bn, _e in pairs]))
    else:
        node = st.node
        cm = dict(st.colmap)
        out = [(c, cm[c]) for c in cols]
    return Compiled(node, cols, out, limit, opt, notes)


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
                 dict_cols=()):
        self.node = node
        self.colmap = list(colmap)
        self.steps: List[tuple] = []
        self.est_rows: Optional[int] = None  # source row estimate
        # frame columns currently dictionary-encoded (string columns on
        # int32 codes): codes support equality / order / passthrough,
        # never arithmetic, so _flush refuses a computing expression over
        # one
        self.dict_cols = set(dict_cols)


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


def _refs(e) -> set:
    out: set = set()
    e.references(out)
    return out


def _flush(st: _DState, out_pairs: List[Tuple[str, Expr]], fused: bool):
    """The pending stage plus the final projection as ONE dense pipeline
    node (or the node itself when that is an identity). Raises VegaError
    when a step computes over a string column or the stage does not run
    on column tensors."""
    node = st.node
    in_schema = tuple(node._schema())
    in_names = [nm for nm, _ in in_schema]
    colmap = list(st.colmap)
    steps = list(st.steps)
    out_names = [bn for bn, _e in out_pairs]
    if not steps:
        ident = dict(colmap)
        if out_names == in_names and all(
                isinstance(e, Col) and ident.get(e.name) == bn
                for bn, e in out_pairs):
            return node  # pure passthrough: nothing to apply
    # Dictionary (string) columns through the stage: codes only ever PASS
    # THROUGH (bare Col); any computing expression over one would compute
    # on codes. `origin` tracks which parent block column each live frame
    # column passes through; the surviving passthroughs become the
    # pipeline's dict_renames, so Block.dicts follows the data.
    dict_live = set(st.dict_cols)
    origin = {fn: bn for fn, bn in colmap}
    for kind, payload in steps:
        if kind == "project":
            for nm, e in payload:
                if not isinstance(e, Col) and _refs(e) & dict_live:
                    raise no_device_lowering(
                        f"expression over string column(s) "
                        f"{sorted(_refs(e) & dict_live)} computes on "
                        "dictionary codes; host tier evaluates it")
            origin = {nm: (origin.get(e.name)
                           if isinstance(e, Col) else None)
                      for nm, e in payload}
            dict_live = {nm for nm, e in payload
                         if isinstance(e, Col) and e.name in dict_live}
        elif _refs(payload) & dict_live:
            raise no_device_lowering(
                f"filter over string column(s) "
                f"{sorted(_refs(payload) & dict_live)} compares "
                "dictionary codes; host tier evaluates it")
    dict_renames = {}
    for bn, e in out_pairs:
        if isinstance(e, Col):
            src = origin.get(e.name)
            if src is not None:
                dict_renames[bn] = src
        elif _refs(e) & dict_live:
            raise no_device_lowering(
                f"expression over string column(s) "
                f"{sorted(_refs(e) & dict_live)} computes on "
                "dictionary codes; host tier evaluates it")
    out_schema: tuple = ()  # set after the probe, which never reads it

    def stage(cols, count, probe: bool):
        """The steps over [n_shards, capacity] columns. Off the probe, on
        the CPU, padded rows take a valid row's values before each
        evaluation (dense_rdd._row_inputs), so no padding can raise
        (100 // 0); with no valid row anywhere the outputs are zeros."""
        like = cols[in_names[0]]
        cap = like.shape[1]
        env = {fn: cols[bn] for fn, bn in colmap}

        def inputs():
            return env if probe else dr._row_inputs(env, count)

        for kind, payload in steps:
            ins = inputs()
            if ins is None:
                return dr._zero_cols(out_schema, like), count
            if kind == "project":
                env = {nm: _column(evaluate(e, ins), like, nm)
                       for nm, e in payload}
            else:
                keep = _column(evaluate(payload, ins), like, "filter")
                keep = keep.to(torch.bool) & kernels.valid_mask(cap, count)
                env, count = kernels.compact(env, keep, cap)
        ins = inputs()
        if ins is None:
            return dr._zero_cols(out_schema, like), count
        return {bn: _column(evaluate(e, ins), like, bn).contiguous()
                for bn, e in out_pairs}, count

    try:
        probe = dr._probe_cols(in_schema, node.n_shards)
        outs, _ = stage(probe, torch.zeros(node.n_shards, dtype=torch.int32),
                        probe=True)
    except Exception as e:  # noqa: BLE001 — any probe failure: no lowering
        why = (str(e).split(dr.HOST_TIER_SUFFIX)[0]
               if isinstance(e, VegaError) else f"{type(e).__name__}: {e}")
        raise no_device_lowering(f"stage does not trace: {why}") from e
    out_schema = tuple((bn, outs[bn].dtype) for bn in out_names)
    token = ("frame_stage", tuple(colmap),
             tuple(_step_token(s) for s in steps),
             tuple((bn, e.token()) for bn, e in out_pairs))
    return dr.dense_pipeline(node, functools.partial(stage, probe=False),
                             out_schema, token, fused=fused,
                             dict_renames=dict_renames)


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


_KEY_DTYPES = {"int32": torch.int32, "float32": torch.float32}


def _key_dtype(node, allowed) -> None:
    dt = dict(node._schema())["k"]
    if dt not in tuple(_KEY_DTYPES[a] for a in allowed):
        raise no_device_lowering(
            f"device exchange key must be {allowed}, got "
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
        node = _flush(st, pairs, fused)
        _key_dtype(node, ("int32", "float32"))
        exchange = _pick_exchange(ctx, options, st, len(pairs), notes)
        sorted_node = node.sort_by_key(ascending=plan.ascending,
                                       exchange=exchange)
        notes.append("sort: device sample-sort exchange")
        out = _DState(sorted_node, [(plan.by, "k")] + list(
            zip(others, [bn for bn, _e in pairs[1:]])),
            dict_cols=_dicts_after(st, plan.columns()))
        out.est_rows = st.est_rows
        return out
    raise no_device_lowering(f"no device lowering for {type(plan).__name__}")


def _lower_group_agg(ctx, plan: L.GroupAgg, options: dict,
                     notes: List[str]) -> _DState:
    fused = bool(options["fuse"])
    st = _lower_device(ctx, plan.child, options, notes)
    specs, slots = _agg_specs(plan)
    live = _dicts_after(st, plan.child.columns())
    ops = [m for _bn, _e, m in specs]
    dict_specs = set()
    for bn, e, m in specs:
        if _refs(e) & live:
            # rank codes make min / max of a string column sound on the
            # device; every other monoid would fold dictionary codes
            if m not in ("min", "max"):
                raise no_device_lowering(
                    f"aggregate '{m}' over string column(s) "
                    f"{sorted(_refs(e) & live)} folds dictionary codes; "
                    "host tier aggregates it")
            if len(set(ops)) != 1:
                raise no_device_lowering(
                    "mixed-op aggregation with a string column has no "
                    "device combiner; host tier aggregates it")
            dict_specs.add(bn)
    out_pairs = [("k", Col(plan.key))] + [(bn, e) for bn, e, _m in specs]
    staged = _flush(st, out_pairs, fused)
    _key_dtype(staged, ("int32",))
    exchange = _pick_exchange(ctx, options, st, len(specs) + 1, notes)
    if len(set(ops)) == 1:
        red = staged.reduce_by_key(op=ops[0], exchange=exchange)
        notes.append(f"groupBy: named-op '{ops[0]}' segment reduce")
    else:
        red = staged.reduce_by_key(func=_traced_tuple_combiner(ops),
                                   exchange=exchange)
        notes.append(f"groupBy: traced tuple combiner over {ops}")
    out = _DState(red, [(plan.key, "k")] + [
        (bn, bn) for bn, _e, _m in specs],
        dict_cols=(({plan.key} if plan.key in live else set())
                   | dict_specs))
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
    fused = bool(options["fuse"])
    lst = _lower_device(ctx, plan.left, options, notes)
    rst = _lower_device(ctx, plan.right, options, notes)
    lvals = [c for c in plan.left.columns() if c != plan.on]
    rvals = [c for c in plan.right.columns() if c != plan.on]
    if len(lvals) != 1 or len(rvals) != 1:
        raise no_device_lowering(
            "device join needs exactly one value column per side "
            f"(have {lvals} x {rvals}); host tier joins the rest")
    lnode = _flush(lst, [("k", Col(plan.on)), ("v", Col(lvals[0]))], fused)
    rnode = _flush(rst, [("k", Col(plan.on)), ("v", Col(rvals[0]))], fused)
    _key_dtype(lnode, ("int32",))
    _key_dtype(rnode, ("int32",))
    exchange = _pick_exchange(ctx, options, lst, 2, notes)
    if plan.how == "inner":
        joined = lnode.join(rnode, exchange=exchange)
    else:
        joined = lnode.left_outer_join(rnode, fill_value=plan.fill_value,
                                       exchange=exchange)
    notes.append(f"join: device sort-merge ({plan.how})")
    llive = _dicts_after(lst, plan.left.columns())
    rlive = _dicts_after(rst, plan.right.columns())
    out = _DState(joined, [(plan.on, "k"), (lvals[0], "lv"),
                           (rvals[0], "rv")],
                  dict_cols=(({plan.on} if plan.on in llive else set())
                             | ({lvals[0]} if lvals[0] in llive else set())
                             | ({rvals[0]} if rvals[0] in rlive
                                else set())))
    out.est_rows = lst.est_rows
    return out


def _unfused_break(st: _DState, cols: List[str]) -> _DState:
    """fuse=False: the pending step(s) as a pipeline of their own that
    materializes through its own chain, so every verb pays its own
    application (the fusion A/B's control leg)."""
    taken: set = set()
    pairs = [(_sanitize(c, taken), Col(c)) for c in cols]
    node = _flush(st, pairs, fused=False)
    out = _DState(node, list(zip(cols, [bn for bn, _e in pairs])),
                  dict_cols=_dicts_after(st, cols))
    out.est_rows = st.est_rows
    return out


_COMBINE = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}


def _traced_tuple_combiner(ops: List[str]):
    """Elementwise monoid combine over the value-column tuple, built from
    torch ops so the reduce traces it (the mixed-op aggregation, e.g.
    sum(x), min(y) in one exchange)."""
    picked = [_COMBINE[op] for op in ops]

    def combine(a, b):
        return tuple(f(x, y) for f, x, y in zip(picked, a, b))

    return combine
