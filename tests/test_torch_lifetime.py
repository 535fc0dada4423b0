"""The block lifetime of vega_tpu_torch against vega_tpu, on the CPU.

A node that materializes registers its block in the Context's LRU; past
dense_hbm_budget the least recently used blocks are dropped, sparing the
node just registered and every block whose settlement is pending, and a
dropped node rematerializes from lineage when read again. Sources never
register. dense_hbm_in_use() is the tracked bytes of live blocks, as in
the reference. The reference reads its budget from Env.get().conf (set
here and restored after); both run on 8 shards under the card's plans.
The lineages compared byte for byte are those whose blocks have equal
capacities and dtypes in both packages (maps, filters, map_values, union,
group_by_key, reduce_by_key over the same source).
"""

import numpy as np
import pytest

import vega_tpu as v
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd

N_SHARDS = 8
PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
         "dense_sort_impl": "xla"}
KV_BYTES = N_SHARDS * 2048 * 2 * 4  # a (k, v) int32 block over 10,000 rows


def _src(ctx):
    """10,000 int32 rows, resident at any budget (dense_range would
    stream under the small budgets below)."""
    return ctx.dense_from_numpy(np.arange(10_000, dtype=np.int32))


class _Ctxs:
    def __init__(self, budget):
        from vega_tpu.env import Env

        self.ref = v.Context("local", num_workers=2)
        conf = Env.get().conf
        keys = list(PLANS) + ["dense_exchange", "dense_hbm_budget"]
        self._restore = {k: getattr(conf, k) for k in keys}
        for k, val in dict(PLANS, dense_exchange="all_to_all",
                           dense_hbm_budget=budget).items():
            setattr(conf, k, val)
        self.port = vt.Context(device="cpu", n_shards=N_SHARDS,
                               dense_hbm_budget=budget, **PLANS)

    def stop(self):
        from vega_tpu.env import Env

        self.port.stop()
        for k, val in self._restore.items():
            setattr(Env.get().conf, k, val)
        self.ref.stop()


@pytest.fixture()
def make_ctxs():
    made = []

    def make(budget=4 << 30):
        made.append(_Ctxs(budget))
        return made[-1].ref, made[-1].port
    try:
        yield make
    finally:
        for c in made:
            c.stop()


def _nodes(ctx):
    """Named nodes of one lineage over 10,000 resident rows, unmaterialized:
    the steps below materialize and read them in one order."""
    kv = _src(ctx).map(lambda x: (x % 100, x))
    return {
        "kv": kv,
        "f": kv.filter(lambda r: r[1] % 2 == 0),
        "mv": kv.map_values(lambda w: w * 2),
        "u": kv.union(kv.map_values(lambda w: w + 1)),
        "g": kv.group_by_key(),
        "red": kv.reduce_by_key(op="add"),
    }


STEPS = ["kv", "f", "mv", "kv", "g", "red", "f", "u", "kv", "mv"]


def _trace(ctx, nodes):
    """After each step (a block() of the named node): tracked bytes and
    the names of the nodes holding a block."""
    out = []
    for name in STEPS:
        nodes[name].block()
        out.append((name, ctx.dense_hbm_in_use(),
                    sorted(nm for nm, nd in nodes.items()
                           if nd._block is not None)))
    return out


@pytest.mark.parametrize("budget", [4 << 30, 3 * KV_BYTES + 1000,
                                    2 * KV_BYTES, KV_BYTES // 2, 0])
def test_eviction_points_match_reference(make_ctxs, budget):
    """The same steps evict the same nodes at the same points, and the
    tracked bytes agree, from no eviction down to a budget of 0 (every
    block but the newest and the pending ones goes)."""
    ref, port = make_ctxs(budget)
    got = _trace(port, _nodes(port))
    exp = _trace(ref, _nodes(ref))
    assert got == exp
    if budget < 3 * KV_BYTES:
        assert any(len(held) < 6 for _, _, held in got)


def test_lru_order_and_the_newest_is_kept(make_ctxs):
    """Touching a block makes it the most recent: the least recently used
    goes first. A block larger than the whole budget is still kept while
    it is the newest."""
    _, port = make_ctxs(2 * KV_BYTES + 1000)
    src = _src(port)
    a, b, c = (src.map(lambda x, i=i: (x % 7, x + i)) for i in range(3))
    a.block()
    b.block()
    a.block()  # touch: b is now the least recently used
    c.block()
    assert a._block is not None and c._block is not None
    assert b._block is None
    assert port.dense_hbm_in_use() == 2 * KV_BYTES
    assert list(port._dense_block_lru) == [a.rdd_id, c.rdd_id]

    tiny = vt.Context(device="cpu", n_shards=N_SHARDS, dense_hbm_budget=100)
    try:
        big = _src(tiny).map(lambda x: (x, x))
        big.block()
        assert big._block is not None
        assert tiny.dense_hbm_in_use() == KV_BYTES
    finally:
        tiny.stop()


def test_sources_never_register(make_ctxs):
    ref, port = make_ctxs(0)
    for ctx in (ref, port):
        src = ctx.dense_from_numpy(np.arange(100, dtype=np.int32))
        src.block()
        src.unpersist()
        assert ctx.dense_hbm_in_use() == 0
        assert src.collect() == list(range(100))
    assert port._dense_block_lru == {}


def test_eviction_then_rematerialization(make_ctxs):
    """An evicted node rebuilds from its lineage on the next read, with
    equal rows, and registers again; a consumer of an evicted reduce
    rebuilds it too."""
    _, port = make_ctxs(KV_BYTES + 1000)
    k = 100
    kv = _src(port).map(lambda x: (x % k, x))
    rows = kv.collect()
    other = _src(port).map(lambda x: (x, x))
    other.block()
    assert kv._block is None
    assert kv.collect() == rows
    assert kv._block is not None and other._block is None

    red = kv.reduce_by_key(op="add")
    sums = sorted(red.collect())
    other.block()
    kv.block()
    assert red._block is None
    table = port.dense_from_numpy(np.arange(k, dtype=np.int32),
                                  np.arange(k, dtype=np.int32) * 2)
    joined = sorted(red.join(table).collect())
    assert joined == [(kk, (s, 2 * kk)) for kk, s in sums]
    assert sums == sorted((kk, sum(range(kk, 10_000, k))) for kk in range(k))


def _pending_reduce(port):
    """A warm reduce whose capacities come from the cold run's hint: its
    launch defers, and its block carries a pending settlement."""
    src = _src(port)
    src.map(lambda x: (x % 100, x)).reduce_by_key(op="add").collect()
    # warm: the same lineage and input sizes reuse the cold capacities
    warm = src.map(lambda x: (x % 100, x)).reduce_by_key(op="add")
    blk = warm.block_spec()
    assert blk.settle is not None
    return warm, blk


def test_pending_blocks_are_not_evicted(make_ctxs):
    """A block whose settlement is pending stays through an eviction
    that takes everything else; once settled it is evictable."""
    _, port = make_ctxs(0)
    warm, blk = _pending_reduce(port)
    other = _src(port).map(lambda x: (x, x))
    other.block()
    assert warm._block is blk and blk.settle is not None
    assert port.dense_hbm_in_use() == KV_BYTES + blk.nbytes
    blk.settle()
    _src(port).map(lambda x: (x, -x)).block()
    assert warm._block is None and other._block is None


def test_unpersist_settles_first(make_ctxs):
    """unpersist settles a pending block before dropping it, so a Block a
    caller holds stays readable; its bytes leave dense_hbm_in_use and the
    next read rematerializes."""
    _, port = make_ctxs()
    warm, blk = _pending_reduce(port)
    before = port.dense_hbm_in_use()
    assert warm.unpersist() is warm
    assert blk.settle is None
    assert warm._block is None
    assert port.dense_hbm_in_use() == before - blk.nbytes
    assert blk.num_rows == 100
    assert sorted(warm.collect()) == sorted(
        (kk, sum(range(kk, 10_000, 100))) for kk in range(100))


def test_unpersist_matches_reference(make_ctxs):
    ref, port = make_ctxs()
    left = []
    for ctx in (ref, port):
        nodes = _nodes(ctx)
        for nd in nodes.values():
            nd.block()
        full = ctx.dense_hbm_in_use()
        nodes["g"].unpersist()
        nodes["mv"].unpersist()
        left.append(ctx.dense_hbm_in_use())
        assert left[-1] == full - 2 * KV_BYTES
        del nodes
    assert left[0] == left[1]


def test_in_use_matches_reference_on_the_main_path_shape(make_ctxs):
    """bench-main's lineage (map, reduce_by_key, join) at small size:
    map and reduce blocks agree byte for byte; the join's capacity is
    each package's own (the reference sizes it from its flat layout), so
    it is compared after being released."""
    ref, port = make_ctxs()
    out = []
    for ctx in (ref, port):
        kv = _src(ctx).map(lambda x: (x % 100, x * 0.5))
        kv.block()
        red = kv.reduce_by_key(op="add")
        red.block()
        table = ctx.dense_from_numpy(np.arange(100, dtype=np.int32),
                                     np.arange(100, dtype=np.float32))
        joined = red.join(table)
        assert joined.count() == 100
        joined.unpersist()
        out.append(ctx.dense_hbm_in_use())
    assert out[0] == out[1] == 2 * KV_BYTES


def test_budget_knob_is_the_reference_default():
    port = vt.Context(device="cpu")
    try:
        from vega_tpu.env import Configuration

        assert port.dense_hbm_budget == Configuration().dense_hbm_budget
    finally:
        port.stop()


def test_dead_nodes_leave_the_accounting(make_ctxs):
    """A node that dies is pruned from the LRU at the next sweep."""
    _, port = make_ctxs()
    kv = _src(port).map(lambda x: (x, x))
    kv.block()
    assert port.dense_hbm_in_use() == KV_BYTES
    del kv
    assert port.dense_hbm_in_use() == 0
    assert port._dense_block_lru == {}
    assert dense_rdd.dense_hbm_in_use(port) == 0
