"""ocean_torch parity: the segment reductions of ``ops/scatter.py``
(kernel 5's plain version among them) and the point-source methods built
on them, against ocean_jax.

Tolerances:
* Ozaki sum vs ``ocean_jax.ops.scatter.ozaki_segment_sum`` and vs
  ``ozaki_segment_sum_pallas`` in interpret mode: 1e-15·max|out|. Both
  packages take the same power-of-two scale and the same 8 integer slices
  and sum each slice exactly; only the final float64 recombination
  Σ_k acc_k·2^-(7+8k)·scale rounds, in a different order.
* Ozaki, binned and sorted sums vs ``np.add.at``: 1e-12·scale, the JAX
  package's own bar (tests/test_point_sources.py).
* ``point_source_rhs`` methods vs JAX's "scatter": atol 1e-13, the bar of
  tests/test_point_sources.py::test_fast_methods_match_scatter (float64
  sums of the same terms in other orders).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ocean_jax.mesh import rectangle_mesh as jax_rectangle_mesh
from ocean_jax.fem import make_space as jax_make_space
from ocean_jax.fem.interpolate import interpolate_p2 as jax_interpolate_p2
from ocean_jax.adjoint import point_source_rhs as jax_psrc
from ocean_jax.ops.scatter import ozaki_segment_sum as jax_ozaki
from ocean_jax.ops.psum_pallas import ozaki_segment_sum_pallas

from ocean_torch import kernels
from ocean_torch.mesh import structured
from ocean_torch.fem import make_space
from ocean_torch.adjoint import point_source_rhs
from ocean_torch.ops.scatter import (ozaki_segment_sum, binned_segment_sum,
                                     sorted_segment_sum)
from ocean_torch.ops.psum_cuda import ozaki_slice_sums

CASES = [(3000, 57), (2048, 7), (5000, 2000)]    # s=7: hot segments


def _data(m, s, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s, m)
    # mixed magnitudes stress the per-column power-of-two slicing
    vals = rng.standard_normal((m, 12)) * 10.0 ** rng.integers(-6, 3, (m, 1))
    ref = np.zeros((s, 12))
    np.add.at(ref, ids, vals)
    return ids, vals, ref


@pytest.mark.parametrize("m,s", CASES)
def test_ozaki_matches_jax(m, s):
    ids, vals, ref = _data(m, s)
    out = ozaki_segment_sum(torch.as_tensor(ids), torch.as_tensor(vals),
                            s).numpy()
    xla = np.asarray(jax_ozaki(jnp.asarray(ids), jnp.asarray(vals), s))
    pal = np.asarray(ozaki_segment_sum_pallas(
        jnp.asarray(ids), jnp.asarray(vals), s, chunk=512, s_tile=1024,
        interpret=True))
    top = np.abs(xla).max()
    assert np.abs(out - xla).max() <= 1e-15 * top
    assert np.abs(out - pal).max() <= 1e-15 * top
    assert np.abs(out - ref).max() < 1e-12 * np.abs(vals).max()


@pytest.mark.parametrize("fn", [binned_segment_sum, sorted_segment_sum])
@pytest.mark.parametrize("m,s", CASES)
def test_float_sums_match_numpy(fn, m, s):
    ids, vals, ref = _data(m, s, seed=4)
    out = fn(torch.as_tensor(ids), torch.as_tensor(vals), s).numpy()
    assert np.abs(out - ref).max() < 1e-12 * np.abs(vals).max()


@pytest.mark.parametrize("fn", [ozaki_segment_sum, binned_segment_sum,
                                sorted_segment_sum])
def test_empty_and_padding_bins(fn):
    ids = torch.tensor([0, 0, 2, 3])            # bin 1 empty; 3 == S → drop
    vals = torch.tensor([[1.0], [2.0], [4.0], [99.0]], dtype=torch.float64)
    assert torch.equal(fn(ids, vals, 3),
                       torch.tensor([[3.0], [0.0], [4.0]],
                                    dtype=torch.float64))


def test_slices_represent_each_value():
    """With one value per segment, the 8 integer slices of r = v/scale
    sum (in exact rational arithmetic) to r within 2^-64; a value with
    |r| = 1 gives the slice -2^7, which int8 could not hold. The plain
    version launches nothing."""
    from fractions import Fraction
    _, vals, _ = _data(60, 5, seed=6)
    top = 2.0 ** np.ceil(np.log2(np.abs(vals[:, 0]).max()))
    vals[0, 0] = -top                          # r = -1 in column 0
    scale = torch.exp2(torch.ceil(torch.log2(
        torch.as_tensor(np.abs(vals).max(axis=0)))))
    before = kernels.launch_counts()
    acc = ozaki_slice_sums(torch.arange(60), torch.as_tensor(vals), scale,
                           60)
    assert kernels.launch_counts() == before
    assert acc.dtype == torch.int64 and int(acc[0, 0, 0]) == -128
    for i in range(60):
        for d in range(12):
            r = Fraction(float(vals[i, d])) / Fraction(float(scale[d]))
            back = sum(Fraction(int(acc[i, k, d]), 2 ** (7 + 8 * k))
                       for k in range(8))
            assert abs(back - r) <= Fraction(1, 2 ** 64)


@pytest.fixture(scope="module")
def psrc_case():
    """tests/test_point_sources.py::test_fast_methods_match_scatter's case:
    an out-of-domain point (source at the center) and a masked buoy."""
    rng = np.random.default_rng(1)
    K, nt, h = 7, 25, 0.01
    sj = jax_make_space(jax_rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8))
    st = make_space(structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), 8, 8),
                    "cpu")
    u = np.asarray(jax_interpolate_p2(sj, lambda c: np.stack(
        [0.1 * c[:, 1], -0.1 * c[:, 0]], axis=1)))
    x = 0.2 + 1.6 * rng.random((K, nt, 2))
    x[3, 5] = [9.0, 9.0]
    mu = rng.standard_normal((K, nt, 2))
    u_d = rng.standard_normal((K, nt, 2))
    mask = np.array([False] * 6 + [True])
    center = np.array([1.0, 1.0])
    b_j = np.asarray(jax_psrc(sj, jnp.asarray(u), jnp.asarray(x),
                              jnp.asarray(mu), jnp.asarray(u_d),
                              jnp.asarray(mask), h, jnp.asarray(center),
                              method="scatter"))
    args = tuple(torch.as_tensor(a) for a in (u, x, mu, u_d, mask))
    return st, args, h, torch.as_tensor(center), b_j


@pytest.mark.parametrize("method", ["binned", "sorted", "ozaki",
                                    "ozaki_pallas"])
def test_psrc_methods_match_jax_scatter(psrc_case, method):
    st, args, h, center, b_j = psrc_case
    b_t = point_source_rhs(st, *args, h, center, method=method).numpy()
    assert b_t.shape == b_j.shape
    assert np.abs(b_t - b_j).max() < 1e-13
    assert not b_t[2 * st.n_p2:].any()          # pressure rows stay 0
