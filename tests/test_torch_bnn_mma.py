"""The arithmetic of ``bnn_matmul_packed``'s ``mma`` route, emulated on the CPU.

The CUDA kernel (``src/repro_torch/csrc/bnn_matmul.cu``, "mma") runs only on
a card.  Its arithmetic is emulated here in plain PyTorch from the C side's
own constants (read from the source): K in stages of ``kMmaStageWords``
words, zero-filled past Kw and past the tile's rows; each word unpacked by
``pm1``'s formula into 32 int8 of +1/-1 in its permuted order (element 4j + b
of a k32 step is bit 8b + j of the word); an int32 dot product; and the
epilogue ``acc - 32 * Kw_staged + k_bits``.  The emulation is held bit for
bit against ``ref.bnn_matmul_packed_ref`` and its expert form on ragged
shapes, and against the reference's Pallas kernel in interpret mode.  The
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import bnn_matmul as tbnn
from repro_torch.kernels import ref as tref

from repro.kernels.bnn_matmul import bnn_matmul_packed as j_bnn_matmul_packed

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - exercised where hypothesis is absent
    from _hypothesis_stub import given, settings, strategies as st

CU = pathlib.Path(tbnn.__file__).resolve().parent.parent / "csrc" / "bnn_matmul.cu"


def _constant(name: str) -> int:
    match = re.search(rf"constexpr int {name} = (\d+);", CU.read_text())
    assert match, f"{name} not found in {CU.name}"
    return int(match.group(1))


STAGE_WORDS = _constant("kMmaStageWords")
BLOCK_M = _constant("kMmaBM")


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def _pm1(words: torch.Tensor, j: int) -> torch.Tensor:
    """``pm1(word, j)`` of the kernel on uint32 values held in int64."""
    return (0xFFFFFFFF - ((words >> j) & 0x01010101) * 0xFE) & 0xFFFFFFFF


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """(R, W) uint32 words (int64) -> (R, 32 W) int8 values in the kernel's
    order: register j of a word holds its elements 4j .. 4j + 3, byte b the
    lowest first."""
    regs = torch.stack([_pm1(words, j) for j in range(8)], dim=-1)          # (R, W, 8)
    signed = torch.stack([(regs >> (8 * b)) & 0xFF for b in range(4)], -1)  # (R, W, 8, 4)
    return (signed - 256 * (signed >= 128)).reshape(words.shape[0], -1)


def mma_emulated(x: torch.Tensor, w: torch.Tensor, k_bits: int, *, block_n: int,
                 staged_epilogue: bool = True) -> torch.Tensor:
    """The mma kernel's arithmetic on (M, Kw) and (N, Kw) int32 bit views.

    Tiles of BLOCK_M x ``block_n`` outputs; each K stage's words copied with
    zeros past Kw and past the operands' rows, unpacked, multiplied and
    summed in int32; the epilogue subtracts 32 per staged word
    (``staged_epilogue``) or, wrongly, per word of Kw."""
    (m, kw), n = x.shape, w.shape[0]
    stages = -(-kw // STAGE_WORDS)
    kw_staged = stages * STAGE_WORDS
    m_pad, n_pad = -(-m // BLOCK_M) * BLOCK_M, -(-n // block_n) * block_n
    xs = torch.zeros((m_pad, kw_staged), dtype=torch.int64)
    ws = torch.zeros((n_pad, kw_staged), dtype=torch.int64)
    xs[:m, :kw], ws[:n, :kw] = _u32(x), _u32(w)
    acc = torch.zeros((m_pad, n_pad), dtype=torch.int64)
    for t in range(stages):
        k = slice(t * STAGE_WORDS, (t + 1) * STAGE_WORDS)
        acc += _unpack(xs[:, k]) @ _unpack(ws[:, k]).T
    assert int(acc.abs().max()) < 2**31  # the int32 accumulators never wrap
    out = acc[:m, :n] - 32 * (kw_staged if staged_epilogue else kw) + k_bits
    return out.to(torch.int32)


def _operands(rng, m, n, kw, k_bits):
    """Random words zero past ``k_bits`` in both, an all-ones row of x and
    an all-zero row of w (and the other way round where there is room)."""
    x = rng.integers(0, 2**32, (m, kw), dtype=np.uint64)
    w = rng.integers(0, 2**32, (n, kw), dtype=np.uint64)
    x[0], w[0] = 2**32 - 1, 0
    if m > 1 and n > 1:
        x[1], w[1] = 0, 2**32 - 1
    bits = np.arange(32 * kw).reshape(kw, 32)
    keep = ((bits < k_bits) * (np.uint64(1) << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint64)
    x, w = x & keep, w & keep
    as_i32 = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32))  # noqa: E731
    return as_i32(x), as_i32(w)


def test_constants_match_the_wrapper():
    assert (STAGE_WORDS, BLOCK_M) == (tbnn.MMA_STAGE_WORDS, tbnn.MMA_BLOCK_M)
    assert STAGE_WORDS % 4 == 0  # whole 128-byte swizzle rows of int8


def test_pm1_spreads_four_bits_without_borrow():
    """Every pattern of bits j, 8 + j, 16 + j, 24 + j gives bytes 0x01 (a 1
    bit) and 0xFF (a 0 bit), the other bits of the word ignored."""
    for j in range(8):
        for pattern in range(16):
            w = sum(((pattern >> b) & 1) << (8 * b + j) for b in range(4))
            want = sum((0x01 if (pattern >> b) & 1 else 0xFF) << (8 * b) for b in range(4))
            others = 0xFFFFFFFF ^ sum(1 << (8 * b + j) for b in range(4))
            for noise in (0, others):
                got = int(_pm1(torch.tensor([w | noise], dtype=torch.int64), j))
                assert got == want, (j, pattern, noise)


def test_unpack_is_the_sign_vector_under_one_permutation():
    """Element 4j + b of a word's 32 is bit 8b + j: the same permutation of
    every word, so dot products of unpacked rows are the ±1 dot products."""
    rng = np.random.default_rng(1)
    words = torch.from_numpy(rng.integers(0, 2**32, (5, 3), dtype=np.uint64).astype(np.int64))
    got = _unpack(words)
    bits = (words[..., None] >> torch.arange(32)) & 1                  # (5, 3, 32): bit i
    perm = torch.tensor([8 * (p % 4) + p // 4 for p in range(32)])
    assert torch.equal(got, (2 * bits[..., perm] - 1).reshape(5, -1))
    assert sorted(perm.tolist()) == list(range(32))


@given(st.integers(1, 300), st.integers(1, 200), st.integers(1, 40), st.integers(0, 10**6),
       st.sampled_from(tbnn.MMA_BLOCK_NS))
@settings(max_examples=25, deadline=None)
def test_emulation_matches_plain_on_ragged_shapes(m, n, kw, seed, block_n):
    rng = np.random.default_rng(seed)
    k_bits = int(rng.integers(32 * (kw - 1) + 1, 32 * kw + 1))  # Kw words hold k_bits
    x, w = _operands(rng, m, n, kw, k_bits)
    got = mma_emulated(x, w, k_bits, block_n=block_n)
    np.testing.assert_array_equal(got.numpy(), tref.bnn_matmul_packed_ref(x, w, k_bits).numpy())


@given(st.integers(1, 6), st.integers(1, 170), st.integers(1, 70), st.integers(1, 20), st.integers(0, 10**6))
@settings(max_examples=15, deadline=None)
def test_emulation_matches_plain_experts(e, c, o, kw, seed):
    """The expert form: each expert's slice is the plain GEMM's (the kernel
    moves its pointers by the expert's strides), at capacities past one row
    tile (C = 160 leaves the second 128-row tile a quarter full)."""
    rng = np.random.default_rng(seed)
    k_bits = 32 * kw - int(rng.integers(0, 32))
    pairs = [_operands(rng, c, o, kw, k_bits) for _ in range(e)]
    x, w = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    block_n = tbnn.mma_block_n(c, o, e, 132)
    got = torch.stack([mma_emulated(x[i], w[i], k_bits, block_n=block_n) for i in range(e)])
    np.testing.assert_array_equal(got.numpy(), tref.bnn_matmul_packed_experts_ref(x, w, k_bits).numpy())


@pytest.mark.parametrize("kw", [1, 3, 5, 9, 13])
def test_zero_words_past_kw_count_in_the_epilogue(kw):
    """Kw not a multiple of the stage: the staged tail's zero words unpack
    to -1 on both sides and add +32 each, so the epilogue subtracts 32 per
    staged word; subtracting it per word of Kw is off by 32 per pad word."""
    assert kw % STAGE_WORDS
    rng = np.random.default_rng(kw)
    k_bits = 32 * kw - 5
    x, w = _operands(rng, 37, 41, kw, k_bits)
    want = tref.bnn_matmul_packed_ref(x, w, k_bits)
    assert torch.equal(mma_emulated(x, w, k_bits, block_n=32), want)
    pad_words = -kw % STAGE_WORDS
    wrong = mma_emulated(x, w, k_bits, block_n=32, staged_epilogue=False)
    assert torch.equal(wrong - want, torch.full_like(want, 32 * pad_words))


@pytest.mark.parametrize("k", [256, 300])
def test_emulation_matches_the_pallas_kernel(k):
    """One tiny divisible shape through the reference's Pallas kernel in
    interpret mode, as ``tests/test_torch_ops.py`` runs it."""
    rng = np.random.default_rng(k)
    kw = -(-k // 32)
    x, w = _operands(rng, 8, 16, kw, k)
    want = j_bnn_matmul_packed(
        jnp.asarray(x.numpy().view(np.uint32)), jnp.asarray(w.numpy().view(np.uint32)), k_bits=k,
        block_m=8, block_n=16, block_kw=kw, interpret=True,
    )
    np.testing.assert_array_equal(mma_emulated(x, w, k, block_n=32).numpy(), np.asarray(want))


@pytest.mark.parametrize("m,n,e,want", [
    (17, 3072, 1, 32), (128, 3072, 1, 32), (128, 8192, 1, 64), (2048, 3072, 1, 128),
    (2048, 8192, 1, 128), (131072, 3072, 1, 128), (160, 768, 128, 128), (160, 2048, 128, 128),
])
def test_tile_width_fills_the_card(m, n, e, want):
    """phi3's prefill (M = 17, 128), scoring (2048) and dry-run prefill
    (131,072) shapes and qwen3's expert scoring launches on 132 SMs."""
    assert tbnn.mma_block_n(m, n, e, 132) == want
    assert want in tbnn.MMA_BLOCK_NS
