"""One spacing of a 16-bit float dtype: the tolerance of a 16-bit output
that the port and the JAX package both compute in f32 and round once."""
import numpy as np


def ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    """The spacing of ``dtype`` (float16 or bfloat16) at each |x|: 2^(e -
    mantissa bits) for |x| in [2^e, 2^(e + 1)), the subnormal spacing below
    the smallest normal."""
    mant, emin = {"float16": (10, -14), "bfloat16": (7, -126)}[dtype]
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** emin)))
    return 2.0 ** (e - mant)


def assert_within_one_spacing(got, want, dtype: str, f32_tol: float):
    """|got - want| within one spacing of ``dtype`` at the larger of the
    two, beyond the f32 sums' own difference ``f32_tol`` (the f32 sweep's
    tolerance): a last-bit difference of the f32 sums flips at most one
    rounding step; near zero, where the spacing is finer than the sums'
    rounding, the f32 term is all.  ``got`` a torch tensor, ``want``
    array-like."""
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    limit = ulp(np.maximum(np.abs(got), np.abs(want)), dtype) + f32_tol
    excess = np.abs(got - want) - limit
    assert excess.max() <= 0, (float(excess.max()), float(limit.max()))
