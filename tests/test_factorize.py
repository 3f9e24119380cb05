"""Dense codes and string dictionaries built with numpy alone: codes in
order of first appearance, NaN/None as one value, order-preserving
sorted dictionaries with NULLs split out."""
import numpy as np
import pytest

from datafusion_tpu.common.column import Dictionary
from datafusion_tpu.physical.hashing import _dense_codes

NAN = float("nan")


@pytest.mark.parametrize("arr,codes", [
    (np.array([5, 3, 5, 9, 3]), [0, 1, 0, 2, 1]),
    (np.array([], np.int64), []),
    (np.array([2**62, -2**62, 2**62]), [0, 1, 0]),             # sparse
    (np.array([7, 7, 0], np.uint64), [0, 0, 1]),
    (np.array([True, False, True]), [0, 1, 0]),
    (np.array([1.0, NAN, 0.0, NAN, 2.0, 1.0]), [0, 1, 2, 1, 3, 0]),
    (np.array([-1.5, 2.5, -1.5]), [0, 1, 0]),
    (np.array(["b", None, "a", NAN, "b"], dtype=object), [0, 1, 2, 1, 0]),
    (np.array(["x", "y", "x"]), [0, 1, 0]),
    (np.array(["2024-01-02", "2024-01-01", "2024-01-02"],
              dtype="datetime64[D]"), [0, 1, 0]),
], ids=["dense int", "empty", "sparse int", "uint", "bool", "float nan",
        "float", "object nulls", "unicode", "datetime"])
def test_dense_codes(arr, codes):
    got, n = _dense_codes(arr)
    assert got.dtype == np.int64
    assert got.tolist() == codes
    assert n == len(set(codes))


@pytest.mark.parametrize("n,span", [(1000, 50), (1000, 10**12), (5, 5000)])
def test_dense_codes_first_appearance(n, span):
    rng = np.random.default_rng(span)
    arr = rng.integers(0, span, n)
    got, count = _dense_codes(arr)
    seen = {}
    expected = [seen.setdefault(v, len(seen)) for v in arr.tolist()]
    assert got.tolist() == expected and count == len(seen)


@pytest.mark.parametrize("raw,codes,valid,values", [
    (["m", "a", "z", "a"], [1, 0, 2, 0], None, ["a", "m", "z"]),
    (["b", None, "a", NAN, "b"], [1, 0, 0, 0, 1],
     [True, False, True, False, True], ["a", "b"]),
    ([None, None], [0, 0], [False, False], []),
    ([], [], None, []),
    ([b"x", b"a"], [1, 0], None, [b"a", b"x"]),
], ids=["sorted codes", "nulls", "all null", "empty", "bytes"])
def test_dictionary_build(raw, codes, valid, values):
    got_codes, got_valid, dic = Dictionary.build(np.array(raw, dtype=object))
    assert got_codes.dtype == np.int32
    assert got_codes.tolist() == codes
    assert (None if got_valid is None else got_valid.tolist()) == valid
    assert dic.values.tolist() == values
