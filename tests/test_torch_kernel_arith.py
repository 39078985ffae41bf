"""The integer arithmetic that the two scatter kernels rely on, in plain
PyTorch on the CPU, held bit for bit (``torch.equal``) to the kernels'
plain versions.

``csrc/point_sources.cu`` sums the limbs of each (32 consecutive points,
square) group as 20-bit pieces before it adds them to a counter;
``csrc/segment_sum.cu`` multiplies by reciprocals of powers of two, rounds
by adding 1.5·2^52, packs two slices into one int and sums each (32
points, id) group first. ``adjoint/cuda_psrc.py`` and ``ops/psum_cuda.py``
hold those steps as plain functions. Every comparison is of integers: no
tolerance. Inputs are numpy-seeded, at Nx=8 and M ≤ 4,096, and include
the inputs that are hard for the grouping: one square or segment for all
points, a different one for every lane, points on nodes and on the
diagonal, ragged M, zero and negative weights, dropped ids, values equal
to ±scale (``tests/torch_kernel_cases.py``, which the card-only tests and
the smoke test run through the kernels).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from ocean_torch.mesh import structured
from ocean_torch.fem.spaces import make_space
from ocean_torch.ode.grideval import make_grideval
from ocean_torch.adjoint.cuda_psrc import (point_source_limbs_plain,
                                           point_source_limbs_grouped,
                                           split20, join20)
from ocean_torch.ops.psum_cuda import (SLICES, ozaki_slice_sums_plain,
                                       ozaki_slice_sums_grouped,
                                       slices_by_reciprocal, pack_slices,
                                       unpack_slice_sums)
from torch_kernel_cases import (PSRC_CASES, SEG_CASES, point_source_case,
                                segment_sum_case)

NX = 8


@pytest.fixture(scope="module")
def ge():
    space = make_space(structured.rectangle_mesh((0.0, 0.0), (2.0, 2.0), NX,
                                                 NX), "cpu")
    return make_grideval(space)


@pytest.mark.parametrize("case", PSRC_CASES)
def test_grouped_point_sources_equal_plain(ge, case):
    pts, r = point_source_case(case, NX)
    hp, lp = point_source_limbs_plain(ge, pts, r)
    hg, lg = point_source_limbs_grouped(ge, pts, r)
    assert hg.dtype == torch.int64 and hg.shape == hp.shape
    assert torch.equal(hg, hp) and torch.equal(lg, lp)
    if case not in ("all_zero_r",):
        assert bool(hp.any())


def test_split20_is_exact_at_the_limb_range():
    """q = a·2^20 + b with 0 ≤ b < 2^20 at the ends of the range of a limb
    (|hi| ≤ 2^40, 0 ≤ lo ≤ 2^40), and 32 lanes of the largest piece stay
    inside an int32."""
    rng = np.random.default_rng(12)
    q = np.concatenate([rng.integers(-2 ** 40, 2 ** 40 + 1, 5000),
                        [-2 ** 40, -2 ** 20 - 1, -2 ** 20, -1, 0, 1,
                         2 ** 20 - 1, 2 ** 20, 2 ** 40]])
    q = torch.as_tensor(q)
    a, b = split20(q)
    assert a.dtype == torch.int32 and b.dtype == torch.int32
    assert int(b.min()) >= 0 and int(b.max()) < 2 ** 20
    assert int(a.abs().max()) * 32 < 2 ** 31
    assert torch.equal(join20(a, b), q)
    # sums of 32 pieces, in int32, give the int64 sum
    rows = q[:4992].reshape(-1, 32)
    a, b = split20(rows)
    assert torch.equal(join20(a.sum(1, dtype=torch.int32),
                              b.sum(1, dtype=torch.int32)), rows.sum(1))


@pytest.mark.parametrize("case", SEG_CASES)
def test_grouped_segment_sum_equals_plain(case):
    ids, vals, scale, S = segment_sum_case(case)
    ap = ozaki_slice_sums_plain(ids, vals, scale, S)
    ag = ozaki_slice_sums_grouped(ids, vals, scale, S)
    assert ag.dtype == torch.int64 and ag.shape == (S, SLICES, vals.shape[1])
    assert torch.equal(ag, ap)
    if case == "plus_minus_scale":
        c = slices_by_reciprocal(vals, scale)
        assert int(c[0].max()) == 128 and int(c[0].min()) == -128


@pytest.mark.parametrize("case", ["random", "plus_minus_scale", "ties"])
def test_reciprocal_slices_equal_divided_slices(case):
    """Slice by slice, not only in the sums: multiplying by reciprocals
    and rounding through 1.5·2^52 gives the integers of the plain
    version's round(r·g), r − c/g."""
    _, vals, scale, _ = segment_sum_case(case)
    c = slices_by_reciprocal(vals, scale)
    r = vals / scale
    for k in range(SLICES):
        g = 2.0 ** (7 + 8 * k)
        ck = torch.round(r * g)
        assert torch.equal(c[k], ck.to(torch.int32))
        r = r - ck / g


def test_subnormal_scale_is_divided():
    """A scale below 2^-1023 has no finite reciprocal: that column is
    divided, and the slices still equal the plain version's."""
    vals = torch.tensor([[2.0 ** -1074, 0.5], [-3 * 2.0 ** -1074, -1.0],
                         [2.0 ** -1073, 0.25]], dtype=torch.float64)
    scale = torch.tensor([2.0 ** -1072, 1.0], dtype=torch.float64)
    assert bool(torch.isinf(1.0 / scale[0]))
    ids = torch.tensor([0, 1, 0])
    assert torch.equal(ozaki_slice_sums_grouped(ids, vals, scale, 2),
                       ozaki_slice_sums_plain(ids, vals, scale, 2))


def test_packed_sums_decode_at_the_extremes():
    """32 lanes of slices ±129 (the largest a slice can be) in either
    half, in every combination of signs."""
    ext = torch.tensor([-129, -128, -1, 0, 1, 128, 129], dtype=torch.int32)
    a, b = torch.meshgrid(ext, ext, indexing="ij")
    c = torch.stack([a.reshape(-1), b.reshape(-1)] * 4)      # (8, 49)
    lanes = c[:, None, :].expand(8, 32, 49)
    sums = pack_slices(lanes).sum(1, dtype=torch.int32)      # (4, 49)
    assert torch.equal(unpack_slice_sums(sums), 32 * c)
    rng = np.random.default_rng(14)
    c = torch.as_tensor(rng.integers(-129, 130, (8, 32, 500)),
                        dtype=torch.int32)
    sums = pack_slices(c).sum(1, dtype=torch.int32)
    assert torch.equal(unpack_slice_sums(sums),
                       c.sum(1, dtype=torch.int32))


finite = st.floats(allow_nan=False, allow_infinity=False, width=64)


@settings(max_examples=300, deadline=None)
@given(v=finite, e=st.integers(-1022, 1023), x=st.floats(-129.0, 129.0),
       k=st.integers(0, 7))
def test_power_of_two_reciprocals_round_alike(v, e, x, k):
    """For a float64 v over the whole exponent range and a power-of-two
    scale with a finite reciprocal, v·(1/scale) == v/scale bit for bit
    (one real number, rounded once; subnormal and overflowing quotients
    included); likewise c·(1/g) == c/g for the slice weights. And
    x + 1.5·2^52 − 1.5·2^52 is round-half-even of x, with the integer in
    the low 32 bits of the sum."""
    scale = torch.tensor(2.0 ** e, dtype=torch.float64)
    inv = 1.0 / scale
    assert bool(torch.isfinite(inv)) and float(inv) * float(scale) == 1.0
    tv = torch.tensor(v, dtype=torch.float64)
    assert torch.equal((tv * inv).view(torch.int64),
                       (tv / scale).view(torch.int64))
    g = torch.tensor(2.0 ** (7 + 8 * k), dtype=torch.float64)
    ck = torch.round(torch.tensor(x, dtype=torch.float64))
    assert torch.equal((ck * (1.0 / g)).view(torch.int64),
                       (ck / g).view(torch.int64))
    t = torch.tensor(x, dtype=torch.float64) + 1.5 * 2.0 ** 52
    assert float(t - 1.5 * 2.0 ** 52) == float(ck)
    assert int(t.view(torch.int64).to(torch.int32)) == int(ck)
