"""The codebook search (kernel 1) on the CPU: the plain version against the
JAX package at Encodec's 1024 x 128 with ties, and a CPU emulation of the
CUDA kernel's arithmetic (csrc/codebook.cu) against the plain version.

The kernel splits the codebook into S slices (one block of a cluster
each), keeps a running (min, index) a row in each slice with a strict '<'
in increasing index order, and merges the slices' pairs by (value, index).
Its scores are, at D <= 16, f32 multiply-adds over d from 0 (x.e and |e|^2),
then |e|^2 - 2 x.e; at D = 128, three TF32 passes on the tensor cores
(small.big + big.small + big.big of the split of ops/kernels/resunit.py,
the tensor cores reading only a small part's top 19 bits), a k8 step at a
time, each wgmma's 8 products added to one f32 accumulator, and |e|^2 as
each lane's four squares summed across the entry's 32 lanes by a
butterfly. The emulation rounds to f32 where the kernel does, but sums a
wgmma's products in f64 and rounds to nearest (the tensor cores' internal
order is not specified, and they round toward zero), so at D = 128 it may
differ from the card in the last bits; its codes may differ from the plain
codes only at near-ties (top-2 score gap within 1e-5 (1 + |s|)), which the
tests count and bound.
"""

import numpy as np
import pytest
import torch

from neuralcodecs_tpu_torch.ops.kernels.codebook import codebook_argmin_plain
from neuralcodecs_tpu_torch.ops.kernels.resunit import tf32_split
from neuralcodecs_tpu_torch.ops.vq import l2_normalize

NONE = np.iinfo(np.int32).max  # the kernel's index of a row with no finite score yet


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tie_inputs(rng, n, d, rows, normalize):
    """16 entries duplicated at the end of the codebook, the latents' first
    16 rows equal to the first copies: those rows' two best scores tie."""
    base, extra = _rand(rng, n - 16, d), _rand(rng, rows, d)
    if normalize:
        base = l2_normalize(torch.from_numpy(base)).numpy()
        extra = l2_normalize(torch.from_numpy(extra)).numpy()
    return np.concatenate([base[:16], extra]), np.concatenate([base, base[:16]])


# ---------------------------------------------------------------- emulation


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once to f32 (the product exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _scores_fma(flat: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """[T, N] scores of the D <= 16 form: fmaf over d from 0 for x.e and for
    |e|^2, then |e|^2 - 2 x.e (2 x.e is exact, so one rounding)."""
    acc = torch.zeros(flat.shape[0], cb.shape[0])
    esq = torch.zeros(cb.shape[0])
    for d in range(flat.shape[1]):
        acc = _fma(flat[:, d:d + 1], cb[None, :, d], acc)
        esq = _fma(cb[:, d], cb[:, d], esq)
    return esq[None, :] - 2.0 * acc


def _tensor_core_operand(small: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an f32 operand: its top 19 bits."""
    return (small.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _scores_tf32(flat: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """[T, N] scores of the D in {32, 64, 128} form (see the module
    docstring)."""
    xb, xs = tf32_split(flat)
    eb, es = tf32_split(cb)
    xs, es = _tensor_core_operand(xs), _tensor_core_operand(es)
    acc = torch.zeros(flat.shape[0], cb.shape[0], dtype=torch.float64)
    for k0 in range(0, flat.shape[1], 8):
        k = slice(k0, k0 + 8)
        for a, b in ((xs, eb), (xb, es), (xb, eb)):  # the kernel's order of passes
            acc = (acc + a[:, k].double() @ b[:, k].double().t()).float().double()
    # |e|^2: lane l holds float4 l of the entry, x^2 then three fmaf, then
    # the butterfly over the entry's lanes (xor 16, 8, 4, 2, 1)
    v = cb.reshape(cb.shape[0], -1, 4)
    lane = v[..., 0] * v[..., 0]
    for c in (1, 2, 3):
        lane = _fma(v[..., c], v[..., c], lane)
    while lane.shape[1] > 1:
        half = lane.shape[1] // 2
        lane = lane[:, :half] + lane[:, half:]
    return lane[:, 0][None, :] - 2.0 * acc.float()


def _slice_best(scores: torch.Tensor, n0: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A block's running (min, index) over its slice's columns, visited in
    increasing index order with a strict '<' from (inf, NONE): the first
    column of the smallest value below +inf; a NaN never compares less,
    -0 and +0 compare equal."""
    t = scores.shape[0]
    if scores.shape[1] == 0:  # an empty last slice
        return torch.full((t,), float("inf")), torch.full((t,), NONE, dtype=torch.int64)
    v = torch.where(torch.isnan(scores), torch.full_like(scores, float("inf")), scores)
    best = v.min(dim=1).values
    hit = (v == best[:, None]) & (v < float("inf"))
    first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + n0,
                        torch.full((t,), NONE, dtype=torch.int64))
    return best, first


def _merge(v, i, best, best_i):
    """The cluster merge's step: (v, i) replaces (best, best_i) if its value
    is less, or equal with a lower index."""
    take = (v < best) | ((v == best) & (i < best_i))
    return torch.where(take, v, best), torch.where(take, i, best_i)


def select_codes(scores: torch.Tensor, slices: int) -> torch.Tensor:
    """The kernel's codes from a [T, N] score matrix: S slices of ns = N / S
    rounded up to 8 entries, each slice's running minimum, merged in slice
    order by (value, index); a row with no finite score gets 0."""
    t, n = scores.shape
    per_slice = -(-n // slices)
    ns = -(-per_slice // 8) * 8
    best = torch.full((t,), float("inf"))
    best_i = torch.full((t,), NONE, dtype=torch.int64)
    for s in range(slices):
        n0 = s * ns
        v, i = _slice_best(scores[:, n0:min(n, n0 + ns)], n0)
        best, best_i = _merge(v, i, best, best_i)
    return torch.where(best_i == NONE, torch.zeros_like(best_i), best_i).to(torch.int32)


def emulate(flat: torch.Tensor, cb: torch.Tensor, slices: int) -> torch.Tensor:
    scores = _scores_fma(flat, cb) if flat.shape[1] <= 16 else _scores_tf32(flat, cb)
    return select_codes(scores, slices)


def _near_ties(flat, cb, got, want) -> tuple[int, float]:
    """(rows whose codes differ, largest plain-score gap among them over
    1 + |s|); every difference must be a near-tie."""
    diff = torch.nonzero(got != want).flatten()
    if diff.numel() == 0:
        return 0, 0.0
    scores = torch.sum(cb * cb, dim=-1)[None, :] - 2.0 * (flat[diff] @ cb.t())
    s_got = scores.gather(1, got[diff].long()[:, None])[:, 0]
    s_want = scores.gather(1, want[diff].long()[:, None])[:, 0]
    return int(diff.numel()), float(((s_got - s_want).abs() / (1 + s_want.abs())).max())


# ----------------------------------------------------------- plain vs JAX


@pytest.fixture(scope="module")
def encodec_ties():
    """Encodec's 1024 x 128 codebook with 16 duplicated entries, 300 rows."""
    return _tie_inputs(np.random.default_rng(8), 1024, 128, 284, normalize=False)


def test_codebook_plain_matches_xla_encodec_width(encodec_ties):
    from neuralcodecs_tpu.ops.vq import _l2_argmin_xla

    x, cb = encodec_ties
    got = codebook_argmin_plain(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_l2_argmin_xla(x, cb)))
    np.testing.assert_array_equal(got[:16], np.arange(16))


def test_codebook_plain_matches_pallas_interpret_encodec_width(encodec_ties):
    from jax.experimental.pallas import tpu as pltpu

    from neuralcodecs_tpu.ops.pallas.codebook import l2_argmin_pallas

    x, cb = encodec_ties
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(l2_argmin_pallas(x, cb))
    got = codebook_argmin_plain(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:16], np.arange(16))


# ------------------------------------------------ emulation vs plain

# (N, D, T, l2-normalised): SNAC's stage, DAC's, Encodec's, the .ecdc golden's
SHAPES = [(4096, 8, 472, True), (1024, 8, 862, True), (1024, 128, 300, False),
          (32, 16, 100, False)]


@pytest.mark.parametrize("slices", [1, 2, 4, 8])
@pytest.mark.parametrize("n,d,t,normalize", SHAPES)
def test_emulated_kernel_matches_plain(n, d, t, normalize, slices):
    """The kernel's arithmetic and merge give the plain codes, except at
    near-ties: at most 1% of the rows, each within 1e-5 (1 + |s|)."""
    rng = np.random.default_rng(1000 * d + t)
    flat, cb = torch.from_numpy(_rand(rng, t, d)), torch.from_numpy(_rand(rng, n, d))
    if normalize:
        flat, cb = l2_normalize(flat), l2_normalize(cb)
    got = emulate(flat, cb, slices)
    want = codebook_argmin_plain(flat, cb)
    assert got.dtype == torch.int32 and got.shape == (t,)
    differ, gap = _near_ties(flat, cb, got, want)
    assert differ <= max(1, t // 100), f"{differ} rows differ"
    assert gap <= 1e-5, f"a differing row's score gap {gap:.2e} is no near-tie"


@pytest.mark.parametrize("n,d,t,normalize", SHAPES[:3])
def test_emulated_kernel_is_independent_of_the_slices(n, d, t, normalize):
    """The merge by (value, index) makes the codes the same for every S."""
    rng = np.random.default_rng(7 * d + t)
    flat, cb = torch.from_numpy(_rand(rng, t, d)), torch.from_numpy(_rand(rng, n, d))
    if normalize:
        flat, cb = l2_normalize(flat), l2_normalize(cb)
    scores = _scores_fma(flat, cb) if d <= 16 else _scores_tf32(flat, cb)
    codes = [select_codes(scores, s) for s in (1, 2, 4, 8)]
    for c in codes[1:]:
        torch.testing.assert_close(c, codes[0], rtol=0, atol=0)


@pytest.mark.parametrize("slices", [1, 2, 4, 8])
@pytest.mark.parametrize("n,d,normalize", [(4096, 8, True), (1024, 128, False)])
def test_emulated_ties_across_slices_go_to_the_lowest_index(n, d, normalize, slices):
    """Duplicates at the end of the codebook lie in the last slice, their
    first copies in the first: the tied rows take the first copies."""
    x, cb = _tie_inputs(np.random.default_rng(d), n, d, 48, normalize)
    got = emulate(torch.from_numpy(x), torch.from_numpy(cb), slices)
    np.testing.assert_array_equal(got[:16].numpy(), np.arange(16))
    want = codebook_argmin_plain(torch.from_numpy(x), torch.from_numpy(cb))
    np.testing.assert_array_equal(want[:16].numpy(), np.arange(16))


# ------------------------------------------------------- signed zeros, NaN

_INF, _NAN = float("inf"), float("nan")


def _row(fill: float, **at: float) -> list[float]:
    """A 32-entry score row (4 slices of 8 at S = 4), ``fill`` but where
    ``at`` (``i5=...``) says."""
    row = [fill] * 32
    for key, value in at.items():
        row[int(key[1:])] = value
    return row


@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("row,want", [
    (_row(50.0, i5=0.0, i20=-0.0), 5),                  # +0 and -0 tie across slices
    (_row(50.0, i5=-0.0, i20=0.0), 5),
    (_row(50.0, i9=-0.0, i12=0.0), 9),                  # and within a slice
    (_row(_NAN, i9=2.0, i25=2.0), 9),                   # a NaN never wins
    (_row(_NAN, i30=4.0), 30),                          # first slices all NaN
    (_row(_NAN), 0),                                    # no finite score: 0
    (_row(_INF, i2=_NAN), 0),
    (_row(1.0, i2=_NAN, i18=-_INF, i27=-_INF), 18),     # -inf is a score like another
])
def test_selection_signed_zeros_and_nan(row, want, slices):
    """Values compare first, never raw bits: -0 and +0 tie and the lowest
    index wins; a NaN never wins, and a row with no score below +inf gets 0
    (unlike torch.argmin, which returns a NaN's index)."""
    scores = torch.tensor([row], dtype=torch.float32)
    assert int(select_codes(scores, slices)[0]) == want
