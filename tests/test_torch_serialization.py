"""Functions by value, without cloudpickle: the port's serialization.py
against the reference's cloudpickle.

Each case's function is pickled by both packages and loaded in a fresh
`python -c` process (the port's with jax, vega_tpu and cloudpickle
unimportable there), where it is called; the two results must be equal
and equal the call in this process. Then the length framing, the
out-of-band buffers and the recorded refusals.
"""

import functools
import io
import json
import pickle
import subprocess
import sys

import cloudpickle
import numpy as np
import pytest

from vega_tpu import serialization as ref_ser
from vega_tpu_torch import serialization
from vega_tpu_torch.errors import VegaError

BASE = np.arange(6, dtype=np.int64)


def _lambda():
    return (lambda x: x * 3 + 1), (4,)


def _nested_closure():
    k = 5

    def outer(a):
        def inner(b):
            return a * b + k
        return inner

    return outer(7), (3,)


def _recursive_closure():
    def fact(n):
        return 1 if n <= 1 else n * fact(n - 1)

    return fact, (6,)


def _closure_over_array():
    arr = np.arange(10, dtype=np.int64) * 2

    def total(i):
        return int(arr[:i].sum()) + int(BASE.sum())

    return total, (7,)


def _partial_of_lambda():
    return functools.partial(lambda a, b, c=0: a * 100 + b * 10 + c, 4), (2,)


def _defaults_and_kwdefaults():
    def f(x, y=3, *, z=11):
        return [x, y, z, x * y + z]

    return f, (2,)


def _global_of_main():
    ns = {"__name__": "__main__", "SCALE": 9}
    exec("def scaled(x):\n    return [x * SCALE, SCALE]\n", ns)
    return ns["scaled"], (5,)


def _nested_code_globals():
    def f(xs):
        return [int(np.sum([v * 2 for v in xs]))] + sorted(
            functools.reduce(lambda a, b: a + [b], xs, []))

    return f, ([3, 1, 2],)


CASES = {
    "lambda": _lambda,
    "nested_closure": _nested_closure,
    "recursive_closure": _recursive_closure,
    "closure_over_array": _closure_over_array,
    "partial_of_lambda": _partial_of_lambda,
    "defaults_and_kwdefaults": _defaults_and_kwdefaults,
    "global_of_main": _global_of_main,
    "nested_code_globals": _nested_code_globals,
}

_LOADER = """
import json, pickle, sys
for name in %r:
    sys.modules[name] = None
cases = pickle.loads(sys.stdin.buffer.read())
out = {}
for name, (blob, args) in cases.items():
    out[name] = pickle.loads(blob)(*args)
print(json.dumps(out))
"""


def _run_fresh(cases, blocked):
    payload = pickle.dumps(cases, protocol=5)
    res = subprocess.run([sys.executable, "-c", _LOADER % (blocked,)],
                         input=payload, capture_output=True, timeout=120,
                         check=False)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    return json.loads(res.stdout.decode().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fresh_results():
    made = {name: make() for name, make in CASES.items()}
    port = {name: (serialization.dumps(f), args)
            for name, (f, args) in made.items()}
    ref = {name: (ref_ser.dumps(f), args)
           for name, (f, args) in made.items()}
    here = {name: json.loads(json.dumps(f(*args)))
            for name, (f, args) in made.items()}
    return (_run_fresh(port, ("jax", "jaxlib", "vega_tpu", "cloudpickle")),
            _run_fresh(ref, ()), here)


@pytest.mark.parametrize("name", list(CASES))
def test_by_value_round_trip_matches_cloudpickle(fresh_results, name):
    port, ref, here = fresh_results
    assert port[name] == ref[name] == here[name]


def test_by_value_rule():
    """By value: __main__, <lambda>, <locals>; by reference: the rest."""
    f, _ = _nested_closure()
    assert serialization._by_value(f)
    assert serialization._by_value(lambda: 0)
    assert serialization._by_value(_global_of_main()[0])
    assert not serialization._by_value(_lambda)  # a module-level function
    blob = serialization.dumps(np.add)
    assert pickle.loads(blob) is np.add
    assert serialization.loads(serialization.dumps(_lambda)) is _lambda


def test_framing_and_oob_buffers():
    stream = io.BytesIO()
    serialization.write_frame(stream, b"abc")
    ref_stream = io.BytesIO()
    ref_ser.write_frame(ref_stream, b"abc")
    assert stream.getvalue() == ref_stream.getvalue() == \
        (3).to_bytes(8, "little") + b"abc"
    stream.seek(0)
    assert serialization.read_frame(stream) == b"abc"
    arr = np.arange(1000, dtype=np.float64)
    head, bufs = serialization.dumps_oob({"a": arr, "f": lambda x: x + 1})
    assert len(bufs) == 1 and bytes(bufs[0]) == arr.tobytes()
    back = serialization.loads_oob(head, [bytearray(b) for b in bufs])
    np.testing.assert_array_equal(back["a"], arr)
    back["a"][0] = -1.0  # writable over a bytearray
    assert back["f"](2) == 3


def test_local_class_is_refused_naming_it():
    """Recorded difference: a class defined in a function does not pickle
    (cloudpickle sends it by value)."""
    class Local:
        pass

    with pytest.raises(VegaError, match="Local"):
        serialization.dumps(Local())
    assert type(cloudpickle.loads(cloudpickle.dumps(Local()))).__name__ \
        == "Local"


def test_bucket_rows_take_the_plain_pickler():
    rows = [(np.int32(i), np.float32(i) * 0.5) for i in range(50)]
    assert serialization.dumps_data(rows) == pickle.dumps(rows, protocol=5)
    with_fn = [(1, lambda: 2)]
    assert serialization.loads(serialization.dumps_data(with_fn))[0][1]() \
        == 2
