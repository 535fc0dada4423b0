"""The port's file sources (vega_tpu_torch/io/readers.py and the
Context's read_source / text_file / whole_text_files / parquet_file)
against vega_tpu's, on the CPU.

Over a directory (with a hidden file and a subdirectory), a glob, one
file and a missing path, each source gives the reference's partitions:
the same groups of whole files (assign_files_to_partitions: the largest
file to the least-loaded partition) and the same rows in each
(glom()). A text source's rows lifted onto the device (dense()) reduce
by key to the reference's host reduce.
"""

import os
import pickle

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.io import readers as ref_readers
import vega_tpu_torch as vt
from vega_tpu_torch.io import readers as port_readers

N_SHARDS = 4


@pytest.fixture(scope="module")
def ctxs():
    # the same default_parallelism: the reference's worker count, the
    # port's shard count
    ref = v.Context("local", num_workers=N_SHARDS)
    port = vt.Context(device="cpu", n_shards=N_SHARDS)
    assert ref.default_parallelism == port.default_parallelism
    try:
        yield ref, port
    finally:
        port.stop()
        ref.stop()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Seeded "k,v" text files of unequal sizes, a hidden file, a
    subdirectory and a line with bytes that are not UTF-8."""
    root = tmp_path_factory.mktemp("files")
    rng = np.random.RandomState(22)
    sizes = [300, 40, 120, 7, 500, 90]
    for i, n in enumerate(sizes):
        keys = rng.randint(0, 50, n)
        vals = rng.randint(-1000, 1000, n)
        (root / f"part-{i}.txt").write_text(
            "".join(f"{k},{x}\n" for k, x in zip(keys, vals)))
    (root / ".hidden").write_text("9,9\n")
    sub = root / "sub"
    sub.mkdir()
    (sub / "z.txt").write_bytes(b"1,2\n3,\xff4\nlast")
    return str(root)


def _parse(line):
    k, x = line.split(",")
    return (int(k), int(x))


PATHS = {
    "dir": lambda root: root,
    "glob": lambda root: os.path.join(root, "part-*.txt"),
    "file": lambda root: os.path.join(root, "part-0.txt"),
    "missing": lambda root: os.path.join(root, "nothing-here"),
}


@pytest.mark.parametrize("num_partitions", [None, 1, 3, 16])
@pytest.mark.parametrize("which", sorted(PATHS))
def test_text_file_partitions_equal_reference(ctxs, tree, which,
                                              num_partitions):
    ref, port = ctxs
    path = PATHS[which](tree)
    want = ref.text_file(path, num_partitions)
    got = port.text_file(path, num_partitions)
    assert got.num_partitions == want.num_partitions
    assert got.glom().collect() == want.glom().collect()


def test_default_partitions_follow_default_parallelism(ctxs, tree):
    ref, port = ctxs
    got = port.text_file(tree)
    assert got.num_partitions == min(port.default_parallelism, 7)
    groups = port_readers.assign_files_to_partitions(
        port_readers._discover(tree), port.default_parallelism)
    assert [s.payload for s in got.splits()] == groups
    assert groups == ref_readers.assign_files_to_partitions(
        ref_readers._discover(tree), port.default_parallelism)


@pytest.mark.parametrize("which", ["dir", "glob", "missing"])
def test_whole_text_files_equal_reference(ctxs, tree, which):
    ref, port = ctxs
    path = PATHS[which](tree)
    want = ref.whole_text_files(path).glom().collect()
    assert port.whole_text_files(path).glom().collect() == want
    for part in want:
        for name, data in part:
            with open(name, "rb") as fh:
                assert fh.read() == data


@pytest.mark.parametrize("decoder", [None, len])
def test_read_source_local_fs_with_decoder(ctxs, tree, decoder):
    ref, port = ctxs
    want = ref.read_source(ref_readers.LocalFsReaderConfig(tree, 3),
                           decoder).glom().collect()
    got = port.read_source(port_readers.LocalFsReaderConfig(tree, 3),
                           decoder).glom().collect()
    assert got == want


def test_host_pin_and_preferred_locations(ctxs, tree):
    _ref, port = ctxs
    cfg = port_readers.TextFileReaderConfig(tree, 2)
    cfg.host = "hostA"
    rdd = port.read_source(cfg).map(lambda line: line.upper())
    src = port.read_source(cfg)
    assert src.preferred_locations(src.splits()[0]) == ["hostA"]
    assert src.is_pinned and rdd.count() == src.count()
    plain = port.text_file(tree, 2)
    assert plain.preferred_locations(plain.splits()[0]) == []


def test_text_lines_reduce_on_the_device_equal_reference(ctxs, tree):
    """text_file(...).map(parse).dense().reduce_by_key(op="add"): a
    device node, equal to the reference's host reduce."""
    ref, port = ctxs
    path = PATHS["glob"](tree)
    want = sorted(ref.text_file(path, 3).map(_parse)
                  .reduce_by_key(lambda a, b: a + b).collect())
    lifted = port.text_file(path, 3).map(_parse).dense()
    from vega_tpu_torch import dense_rdd

    assert isinstance(lifted, dense_rdd.DenseRDD)
    got = lifted.reduce_by_key(op="add")
    assert isinstance(got, dense_rdd.DenseRDD)
    assert sorted(got.collect()) == want
    joined = got.join(port.parallelize([(k, -k) for k in range(0, 50, 2)],
                                       2).dense())
    assert sorted(joined.collect()) == sorted(
        (k, (s, -k)) for k, s in want if k % 2 == 0)


def test_decoded_lines_with_bad_bytes_equal_reference(ctxs, tree):
    ref, port = ctxs
    path = os.path.join(tree, "sub")
    want = ref.text_file(path).collect()
    assert port.text_file(path).collect() == want
    assert want == ["1,2", "3,�4", "last"]


@pytest.fixture(scope="module")
def parquet_tree(tmp_path_factory):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    root = tmp_path_factory.mktemp("pq")
    rng = np.random.RandomState(7)
    for i, n in enumerate([50, 200, 20]):
        table = pa.table({"k": rng.randint(0, 10, n).astype(np.int64),
                          "x": rng.standard_normal(n),
                          "s": [f"w{j % 4}" for j in range(n)]})
        pq.write_table(table, str(root / f"f{i}.parquet"), row_group_size=64)
    (root / "notes.txt").write_text("not parquet\n")
    return str(root)


def _blocks(parts):
    return [[{k: np.asarray(c).tolist() for k, c in blk.items()}
             for blk in part] for part in parts]


@pytest.mark.parametrize("columns", [None, ["x", "k"]])
@pytest.mark.parametrize("num_partitions", [None, 2])
def test_parquet_file_equals_reference(ctxs, parquet_tree, columns,
                                       num_partitions):
    ref, port = ctxs
    want = ref.parquet_file(parquet_tree, columns, num_partitions)
    got = port.parquet_file(parquet_tree, columns, num_partitions)
    assert got.num_partitions == want.num_partitions
    assert _blocks(got.glom().collect()) == _blocks(want.glom().collect())


def test_parquet_rows_and_predicate_equal_reference(ctxs, parquet_tree):
    ref, port = ctxs
    pred = [("k", ">=", 5)]
    want = ref_readers.ParquetReaderConfig(
        parquet_tree, ["k", "s"], 2, predicate=pred).rows(ref).collect()
    got = port_readers.ParquetReaderConfig(
        parquet_tree, ["k", "s"], 2, predicate=pred).rows(port).collect()
    assert [tuple(np.asarray(c).item() for c in r) for r in got] == \
        [tuple(np.asarray(c).item() for c in r) for r in want]
    assert got and all(r[0] >= 5 for r in got)


def test_parquet_refusals_equal_reference(ctxs, tmp_path):
    ref, port = ctxs
    (tmp_path / "a.txt").write_text("x\n")
    for path in (str(tmp_path / "none"), str(tmp_path)):
        with pytest.raises(Exception) as want:
            ref.parquet_file(path)
        with pytest.raises(vt.VegaError) as got:
            port.parquet_file(path)
        assert str(got.value) == str(want.value)


def test_file_groups_pickle(ctxs, tree):
    """A file source's splits carry their groups, and pickle (stdlib)."""
    _ref, port = ctxs
    splits = port.text_file(tree, 3).splits()
    assert pickle.loads(pickle.dumps(splits[0].payload)) == \
        splits[0].payload
