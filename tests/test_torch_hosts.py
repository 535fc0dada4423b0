"""Hosts files and the ssh launch of vega_tpu_torch (hosts.py,
distributed/backend.py) against vega_tpu's, on the CPU.

Parsing and loading give the reference's Hosts; a hosts file that is
named but missing raises as the reference's backend does. The ssh path
runs end to end through a stand-in ssh on PATH (it runs the remote
command on this host, with the executor bound to 127.0.0.1): a hosts
file of two remote slots starts both executors over it, a job gives the
local fleet's rows, and when the local ssh client of one slot dies the
remote executor is killed over ssh by the pid it registered. A real
remote host is not run here. Counterparts of tests/test_hosts.py's five
tests and tests/test_elastic.py:218.
"""

import operator
import os
import sys
import time

import pytest

import vega_tpu as v
from vega_tpu.distributed.backend import (
    _weighted_scale_host as ref_weighted)
from vega_tpu.errors import NetworkError as RefNetworkError
from vega_tpu.errors import VegaError as RefVegaError
from vega_tpu.hosts import Hosts as RefHosts
import vega_tpu_torch as vt
from vega_tpu_torch.distributed.backend import _weighted_scale_host
from vega_tpu_torch.errors import NetworkError, VegaError
from vega_tpu_torch.hosts import Hosts

TEXTS = ["""
# cluster
master = 10.0.0.1
slaves = 10.0.0.2, 10.0.0.3:2, 10.0.0.4
""", "# nothing\n\n", "master=m\nslaves = a:2, b, c:0\n"]


@pytest.mark.parametrize("text", TEXTS)
def test_parse_equals_the_references(text):
    got, want = Hosts.parse(text), RefHosts.parse(text)
    assert (got.master, got.slaves) == (want.master, want.slaves)


def test_parse_basic():
    h = Hosts.parse(TEXTS[0])
    assert h.master == "10.0.0.1"
    assert h.slaves == ["10.0.0.2", "10.0.0.3", "10.0.0.3", "10.0.0.4"]


def test_parse_empty_and_comments():
    h = Hosts.parse(TEXTS[1])
    assert (h.master, h.slaves) == ("127.0.0.1", [])


@pytest.mark.parametrize("text", ["not a key value line",
                                  "slaves = host:xyz", "unknown = 1",
                                  "slaves = a:-1"])
def test_parse_errors(text):
    with pytest.raises(RefVegaError) as ref_err:
        RefHosts.parse(text)
    with pytest.raises(VegaError) as err:
        Hosts.parse(text)
    assert str(err.value) == str(ref_err.value)


def test_load_missing_file(tmp_path):
    assert Hosts.load(str(tmp_path / "nope.conf")).slaves == []


def test_load_file(tmp_path):
    p = tmp_path / "hosts.conf"
    p.write_text("master=m\nslaves = a:2, b\n")
    h = Hosts.load(str(p))
    assert (h.master, h.slaves) == ("m", ["a", "a", "b"])


def test_weighted_scale_host_is_capacity_proportional():
    weights = {"big": 3, "small": 1}
    orders = []
    for fn in (_weighted_scale_host, ref_weighted):
        live = {}
        order = []
        for _ in range(8):
            h = fn(weights, live)
            order.append(h)
            live[h] = live.get(h, 0) + 1
        orders.append(order)
    assert orders[0] == orders[1] == ["big", "big", "big", "small", "big",
                                      "big", "big", "small"]
    assert _weighted_scale_host({}, {}) == "127.0.0.1"
    assert _weighted_scale_host({"only": 2}, {"only": 7}) == "only"


def test_missing_hosts_file_raises_as_the_references(tmp_path):
    missing = str(tmp_path / "absent.conf")
    prev = v.Context.active()
    if prev is not None:
        prev.stop()
    with pytest.raises(RefNetworkError, match="does not exist"):
        v.Context("distributed", hosts_file=missing)
    with pytest.raises(NetworkError, match="does not exist"):
        vt.Context(mode="distributed", device="cpu", n_shards=2,
                   hosts_file=missing)


FAKE_SSH = """#!{python}
# stands in for ssh: runs the remote command on this host as a child of
# its own (as a remote process is not the client), the executor bound to
# 127.0.0.1; logs each call
import subprocess, sys
args = sys.argv[2:]
with open({log!r}, "a") as f:
    f.write(sys.argv[1] + " " + " ".join(args) + "\\n")
if "--host" in args:
    args[args.index("--host") + 1] = "127.0.0.1"
sys.exit(subprocess.call(args))
"""


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def test_ssh_launch_and_remote_kill(tmp_path, monkeypatch):
    log = tmp_path / "ssh.log"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    ssh = bindir / "ssh"
    ssh.write_text(FAKE_SSH.format(python=sys.executable, log=str(log)))
    ssh.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(os.path.dirname(
        os.path.abspath(vt.__file__))))
    hosts = tmp_path / "hosts.conf"
    hosts.write_text("master = 127.0.0.1\nslaves = node-a, node-b\n")
    rows = [(i % 9, i) for i in range(300)]
    want = sorted({k: sum(x for kk, x in rows if kk == k)
                   for k in range(9)}.items())
    ctx = vt.Context(mode="distributed", device="cpu", n_shards=2,
                     hosts_file=str(hosts), num_workers=2,
                     executor_max_restarts=0, executor_reap_interval_s=0.5)
    try:
        backend = ctx._backend
        fleet = sorted((r["executor_id"], r["host"])
                       for r in backend.fleet_snapshot())
        assert fleet == [("exec-0", "node-a"), ("exec-1", "node-b")]
        launched = log.read_text().splitlines()
        assert sorted(line.split()[0] for line in launched) == \
            ["node-a", "node-b"]
        assert all(line.split()[1] == "env" for line in launched)
        # the executor's settings ride the remote command line
        assert all("VEGA_TPU_FETCH_RETRIES=3" in line for line in launched)
        assert sorted(ctx.parallelize(rows, 4).reduce_by_key(
            operator.add, 3).collect()) == want
        # the local ssh client of node-b dies: the reaper declares the
        # slot lost and kills the executor over ssh by its pid
        victim = backend._executors["exec-1"]
        pid = backend.service.workers["exec-1"]["pid"]
        victim.process.kill()
        victim.process.wait()
        assert _alive(pid)
        deadline = time.time() + 20.0
        while _alive(pid) and time.time() < deadline:
            time.sleep(0.1)
        assert not _alive(pid), "the remote executor outlived its slot"
        assert any(line.startswith("node-b kill") for line in
                   log.read_text().splitlines())
        assert sorted(ctx.parallelize(rows, 4).reduce_by_key(
            operator.add, 3).collect()) == want
    finally:
        ctx.stop()
