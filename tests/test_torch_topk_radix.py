"""The digit arithmetic of the top-k kernel's radix select
(``csrc/topk_mask.cu``), followed in numpy, against the plain counting
search (`topk_threshold_bits_ref`) and the JAX package's Pallas kernel
`topk_threshold_bits_3d` in interpret mode. The kernel itself runs only
on the card; this holds its schedule (`ops.DIGIT_BITS`, bits 30..0), the
prefix and remaining k it carries between passes, the per-block
histograms merged by addition and the top-down bin scan to the same bits,
exactly, on the JAX package's edge cases (mixed signs, all negative,
ties, subnormals, all zeros) plus NaN and infinities, and on random
sizes with k = 1, k = n and exactly k non-zero values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_mask.topk_mask import topk_threshold_bits_3d
from repro_torch import tree
from repro_torch.kernels.topk_mask import ops as kops
from repro_torch.kernels.topk_mask.ref import topk_threshold_bits_ref
from test_torch_selection import CASES, FRAC, _u_case


def radix_select(bits: np.ndarray, k: int, digit_bits=kops.DIGIT_BITS,
                 blocks: int = 1) -> np.ndarray:
    """Per-session threshold bits as the kernel finds them: for each digit
    (widest first, from bit 30), each block's histogram of the digit over
    the values whose higher bits equal the prefix (blocks take interleaved
    slices), summed; then from the top bin down, the first bin at which
    the running count reaches the remaining k. A pattern with the sign
    bit set counts as 0."""
    flat = bits.reshape(bits.shape[0], -1).view(np.uint32)
    flat = np.where(flat & np.uint32(0x80000000), np.uint32(0), flat)
    out = np.zeros(flat.shape[0], np.uint32)
    for b, v in enumerate(flat):
        prefix, krem, shift = 0, k, 31
        for width in digit_bits:
            shift -= width
            hi, bins = shift + width, 1 << width
            digit = (v[(v >> hi) == (prefix >> hi)] >> shift) & (bins - 1)
            hist = sum(np.bincount(digit[j::blocks], minlength=bins)
                       for j in range(blocks))
            at_or_above = np.cumsum(hist[::-1])  # from the top bin down
            j = int(np.searchsorted(at_or_above, krem))  # first to reach krem
            d = bins - 1 - j
            krem -= int(at_or_above[j] - hist[d])  # the count above bin d
            prefix |= d << shift
        out[b] = prefix
    return out


def _stacked_case(case: str, rng):
    """The JAX package's edge cases (as chip_smoke.py's K2 phase runs
    them), 3 sessions of two leaves, stacked."""
    trees = _u_case(case, rng)
    return tree.tree_map(lambda *ls: torch.from_numpy(np.stack(ls)), *trees)


def _all_agree(bits: torch.Tensor, k: int, blocks=(1, 3), jax_too=True):
    want = topk_threshold_bits_ref(bits, k).numpy().view(np.uint32)
    for nb in blocks:
        assert np.array_equal(radix_select(bits.numpy(), k, blocks=nb), want), nb
    if jax_too:
        jbits = jnp.asarray(bits.numpy().view(np.uint32))
        got = np.asarray(topk_threshold_bits_3d(jbits, k, interpret=True)).reshape(-1)
        assert np.array_equal(got, want)
    return want


def test_digit_schedule_is_one_the_kernel_takes():
    """Bits 30..0 exactly, at most 4 digits of at most 11 bits (a block's
    histogram of 2,048 bins)."""
    assert sum(kops.DIGIT_BITS) == 31
    assert 1 <= len(kops.DIGIT_BITS) <= 4
    assert all(1 <= w <= 11 for w in kops.DIGIT_BITS)


@pytest.mark.parametrize("case", CASES)
def test_radix_select_edge_cases(case):
    bits, n = kops.abs_bits_buffer(_stacked_case(case, np.random.default_rng(5)))
    _all_agree(bits, kops.selection_count(n, FRAC))


@pytest.mark.parametrize("digit_bits", [(11, 10, 10), (8, 8, 8, 7), (7, 8, 8, 8),
                                        (1, 10, 10, 10)])
def test_any_digit_schedule_gives_the_same_bits(digit_bits):
    rng = np.random.default_rng(9)
    for case in ("mixed", "ties", "nan", "denormals"):
        bits, n = kops.abs_bits_buffer(_stacked_case(case, rng))
        for k in (1, 37, kops.selection_count(n, FRAC), n):
            want = topk_threshold_bits_ref(bits, k).numpy().view(np.uint32)
            assert np.array_equal(radix_select(bits.numpy(), k, digit_bits, 2), want)


@pytest.mark.parametrize("sessions,rows", [(1, 3), (13, 5), (3, 40)])
def test_radix_select_random_sizes(sessions, rows):
    """k = 1, k = n (padding included), a random k, and a session with
    exactly k non-zero values (the threshold is the smallest of them)."""
    rng = np.random.default_rng(sessions * 100 + rows)
    x = (rng.normal(size=(sessions, rows, 128)) *
         np.exp(rng.uniform(-30, 30, size=(sessions, rows, 128)))).astype(np.float32)
    bits = torch.from_numpy(np.abs(x)).view(torch.int32)
    n = rows * 128
    for k in (1, n, int(rng.integers(1, n))):
        _all_agree(bits, k)
    k = int(rng.integers(2, n // 2))
    sparse = np.zeros_like(x)
    for b in range(sessions):
        idx = rng.choice(n, size=k, replace=False)
        sparse[b].reshape(-1)[idx] = np.abs(x[b].reshape(-1)[idx]) + 1e-30
    bits = torch.from_numpy(sparse).view(torch.int32)
    want = _all_agree(bits, k)
    assert np.array_equal(want, sparse.reshape(sessions, -1).min(
        axis=1, where=sparse.reshape(sessions, -1) > 0, initial=np.inf).view(np.uint32))
    # k + 1 with only k values non-zero: the threshold is 0
    assert np.all(_all_agree(bits, k + 1) == 0)


def test_sign_bit_counts_as_zero():
    """Patterns with the sign bit set sort below every candidate in the
    int32 counting search; the radix select counts them as 0."""
    bits = torch.zeros(2, 1, 128, dtype=torch.int32)
    bits[:, 0, :5] = torch.tensor([5, -7, 3, -1, 9], dtype=torch.int32)
    for k in (1, 2, 3, 4, 128):
        _all_agree(bits, k, jax_too=False)
