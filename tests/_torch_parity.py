"""Column-by-column equality of two Datasets, one from each package.

``assert_same(a, b)`` holds a port Dataset to a JAX one: the same column
names, and each column equal value for value — numeric arrays bit-equal
(NaN equal to NaN, dtypes equal), object columns and lists element by
element, recursively. ``atol`` loosens numeric comparisons where a test
states a tolerance. ``f32_ulps(got, want)`` is the largest distance of two
f32 arrays in units in the last place.
"""

import numpy as np


def _same_value(x, y, atol: float, where: str) -> None:
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, f"{where}: shape {x.shape} != {y.shape}"
        if x.dtype.kind in "fciub" and y.dtype.kind in "fciub":
            if atol:
                np.testing.assert_allclose(x, y, rtol=0, atol=atol,
                                           err_msg=where)
            else:
                assert x.dtype == y.dtype, f"{where}: {x.dtype} != {y.dtype}"
                np.testing.assert_array_equal(x, y, err_msg=where)
            return
        assert x.dtype == y.dtype, f"{where}: {x.dtype} != {y.dtype}"
        for i, (u, v) in enumerate(zip(x.ravel().tolist(),
                                       y.ravel().tolist())):
            _same_value(u, v, atol, f"{where}[{i}]")
        return
    if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
        assert len(x) == len(y), f"{where}: {len(x)} != {len(y)} items"
        for i, (u, v) in enumerate(zip(x, y)):
            _same_value(u, v, atol, f"{where}[{i}]")
        return
    if isinstance(x, dict) and isinstance(y, dict):
        assert set(x) == set(y), f"{where}: keys {set(x)} != {set(y)}"
        for k in x:
            _same_value(x[k], y[k], atol, f"{where}[{k!r}]")
        return
    if isinstance(x, float) and isinstance(y, float) and np.isnan(x):
        assert np.isnan(y), f"{where}: {x} != {y}"
        return
    if atol and isinstance(x, (int, float)) and isinstance(y, (int, float)):
        assert abs(x - y) <= atol, f"{where}: {x} != {y}"
        return
    assert type(x) is type(y) or (np.isscalar(x) and np.isscalar(y)), (
        f"{where}: {type(x)} != {type(y)}")
    assert x == y, f"{where}: {x!r} != {y!r}"


def assert_same(a, b, atol: float = 0.0) -> None:
    """Port Dataset ``a`` equals JAX Dataset ``b`` column by column."""
    assert list(a.columns) == list(b.columns), (a.columns, b.columns)
    for c in a.columns:
        _same_value(a[c], b[c], atol, c)


def f32_ulps(got, want) -> float:
    """The largest distance between two f32 arrays of one shape, in units
    of the last place of the larger magnitude at each element."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, f"shape {got.shape} != {want.shape}"
    if got.size == 0:
        return 0.0
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return float((np.abs(got.astype(np.float64) - want.astype(np.float64))
                  / ulp).max())
