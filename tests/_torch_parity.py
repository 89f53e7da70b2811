"""Shared helpers of the tests that hold repro_torch against the JAX
package: numpy-made inputs handed to both, JAX results moved over as
numpy, and leaf-by-leaf comparisons at the stated tolerances."""
import numpy as np
import torch

# Tower outputs and the values cached from them: XLA and torch sum
# matmuls, softmax and layer norm in different orders.
TOWER_ATOL, TOWER_RTOL = 2e-5, 1e-4
# float32 counter sums (staleness/age sums), summed in another order.
SUM_RTOL = 1e-6


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_torch(tree):
    """A JAX NamedTuple of arrays (CacheState, WriteBuffer, ...) as the
    same NamedTuple type's torch twin, on the CPU."""
    return [torch.tensor(np.asarray(x)) for x in tree]


def assert_exact(got, want, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_float(got, want, what="", atol=TOWER_ATOL, rtol=TOWER_RTOL):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol,
                               rtol=rtol, err_msg=what)


def assert_tree(got, want, float_fields=(), what=""):
    """NamedTuples leaf by leaf: float leaves named in ``float_fields`` at
    the tower tolerance, every other leaf bit for bit."""
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name in float_fields:
            assert_float(g, w, f"{what}.{name}")
        else:
            assert_exact(g, w, f"{what}.{name}")
