"""Port kernels: each plain version against the reference Pallas kernel (in
interpret mode) or the reference executor, plus the wrappers' validation.

Everything is bit-exact.  The CUDA kernels themselves are held against these
plain versions on a card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import bitops as tb
from repro_torch.core import compiler as tcompiler
from repro_torch.core import pipeline as tpipe
from repro_torch.dataplane import executor as texec
from repro_torch.dataplane import lowering as tlow
from repro_torch.kernels import _build
from repro_torch.kernels import bitpack as tbitpack
from repro_torch.kernels import ops as tops
from repro_torch.kernels import optable_exec as topt
from repro_torch.kernels import packed_layer as tpl

from repro.core import compiler as jcompiler
from repro.core import pipeline as jpipe
from repro.dataplane import executor as jexec
from repro.kernels import bitpack as jbitpack
from repro.kernels import optable_exec as jopt

TABLES = ("opcode", "dst", "src0", "src1", "imm0", "imm1", "mask", "first_write")


def _params(sizes, seed):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 2, (sizes[i + 1], sizes[i])).astype(np.int32)
        for i in range(len(sizes) - 1)
    ]


def _lowered(sizes, native_popcnt=False, seed=0):
    chip = tpipe.RMT_NATIVE_POPCNT if native_popcnt else tpipe.RMT
    return tcompiler.compile_bnn(_params(sizes, seed), chip).lower()


def _tables(lp, device="cpu"):
    return tuple(texec._i32(getattr(lp, name)).to(device) for name in TABLES)


def _random_regs(num_regs, batch, seed):
    """Arbitrary uint32 register contents, high bit and all-ones included."""
    rng = np.random.default_rng(seed)
    regs = rng.integers(0, 1 << 32, (num_regs, batch), dtype=np.uint64).astype(np.uint32)
    regs[0, :2] = (0x80000000, 0xFFFFFFFF)
    regs[-1] = 0  # the null register
    return regs


# ---------------------------------------------------------------------------
# optable_run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native_popcnt", [False, True])
def test_optable_plain_matches_pallas_interpret(native_popcnt):
    lp = _lowered((40, 5, 3), native_popcnt, seed=1)
    regs = _random_regs(lp.num_regs, 8, seed=2)
    ref = jopt.optable_run(
        jnp.asarray(regs), *(jnp.asarray(getattr(lp, n)) for n in TABLES), interpret=True
    )
    port = topt.optable_run(tb.u32_to_i32(torch.from_numpy(regs.astype(np.int64))), *_tables(lp))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).view(np.int32))


@pytest.mark.parametrize("native_popcnt", [False, True])
def test_optable_plain_matches_reference_executor_on_headline(native_popcnt):
    lp = _lowered((32, 64, 32), native_popcnt, seed=3)
    jchip = jpipe.RMT_NATIVE_POPCNT if native_popcnt else jpipe.RMT
    jlp = jcompiler.compile_bnn(_params((32, 64, 32), 3), jchip).lower()
    regs = _random_regs(lp.num_regs, 64, seed=4)
    ref = jexec.run_hop(jlp, jnp.asarray(regs), backend="jnp")
    port = topt.optable_run_segmented(
        tb.u32_to_i32(torch.from_numpy(regs.astype(np.int64))), *_tables(lp), runs=lp.opcode_runs()
    )
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).view(np.int32))


def _hand_table(rows):
    """One element from (opcode, dst, src0, src1, imm0, imm1, mask, first)."""
    cols = list(zip(*rows))
    return tuple(
        torch.from_numpy(np.array([c], np.int64).astype(np.uint32).view(np.int32)) for c in cols
    )


def test_optable_plain_alu_edges():
    regs = np.zeros((5, 3), np.uint32)
    regs[0] = (0x80000000, 0xFFFFFFFF, 7)
    regs[1] = (1, 0xFFFFFFFF, 0x80000000)
    full = 0xFFFFFFFF
    tables = _hand_table([
        (tlow.SHR_AND_IMM, 2, 0, 4, 32, full, full, 1),  # shift by 32 -> 0
        (tlow.SHL_IMM, 3, 0, 4, 31, 0, full, 1),         # bit 0 -> bit 31
        (tlow.ADD, 1, 0, 1, 0, 0, full, 1),              # wraps mod 2**32
        (tlow.GE_IMM, 0, 0, 4, 0x80000000, 0, full, 1),  # unsigned compare
        (tlow.POPCNT, 4, 1, 4, 0, 0, 0, 1),              # mask 0 keeps null 0
    ])
    out = topt.optable_run(tb.u32_to_i32(torch.from_numpy(regs.astype(np.int64))), *tables)
    out = tb.i32_to_u32(out).numpy()
    np.testing.assert_array_equal(out[2], [0, 0, 0])
    np.testing.assert_array_equal(out[3], [0, 0x80000000, 0x80000000])
    np.testing.assert_array_equal(out[1], [0x80000001, 0xFFFFFFFE, 0x80000007])
    np.testing.assert_array_equal(out[0], [1, 1, 0])
    np.testing.assert_array_equal(out[4], [0, 0, 0])


def test_optable_write_back_is_in_row_order():
    regs = np.zeros((4, 2), np.uint32)
    regs[0] = (1, 2)
    regs[1] = (10, 20)
    full = 0xFFFFFFFF
    tables = _hand_table([
        (tlow.XOR_IMM, 2, 0, 3, 0, 0, full, 1),   # first write: r2 = r0
        (tlow.SHL_IMM, 2, 1, 3, 4, 0, full, 0),   # continuation: r2 += r1 << 4
        (tlow.XOR_IMM, 1, 0, 3, 0, 0, full, 0),   # continuation only: r1 += r0
        (tlow.XOR_IMM, 0, 1, 3, 0, 0, full, 1),   # swaps read the incoming file
    ])
    out = tb.i32_to_u32(
        topt.optable_run(tb.u32_to_i32(torch.from_numpy(regs.astype(np.int64))), *tables)
    ).numpy()
    np.testing.assert_array_equal(out[2], [1 + 160, 2 + 320])
    np.testing.assert_array_equal(out[1], [11, 22])
    np.testing.assert_array_equal(out[0], [10, 20])


@pytest.mark.parametrize("field,value", [("opcode", 6), ("opcode", -1), ("dst", 99), ("src1", -2)])
def test_optable_rejects_malformed_tables(field, value):
    lp = _lowered((5, 3))
    tables = list(_tables(lp))
    tables[TABLES.index(field)][0, 0] = value
    regs = torch.zeros((lp.num_regs, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        topt.optable_run(regs, *tables)


def test_optable_segmented_checks_runs():
    lp = _lowered((5, 3))
    regs = torch.zeros((lp.num_regs, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        topt.optable_run_segmented(regs, *_tables(lp), runs=((0, 1, (0,)),))
    with pytest.raises(ValueError):
        topt.optable_run(regs.to(torch.int64), *_tables(lp))


# A full-height scratch (max_rows slots a packet): the block size that keeps
# the most packets resident on an SM (192, 416 and 64 here).
@pytest.mark.parametrize(
    "sizes,native,threads",
    [((32, 64, 32), False, 64), ((32, 64, 32), True, 32), ((128, 64, 32, 2), False, 64)],
)
def test_block_threads_fit_shared_memory(sizes, native, threads):
    lp = _lowered(sizes, native)
    assert topt.block_threads(lp.num_regs, lp.max_rows) == threads
    assert (lp.num_regs + lp.max_rows) * 4 * threads <= _build.MAX_SHARED_BYTES


def test_block_threads_raises_when_nothing_fits():
    with pytest.raises(ValueError):
        topt.block_threads(1000, 1000)


# ---------------------------------------------------------------------------
# bitpack / pack_bits_words
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100])
def test_pack_bits_words_matches_pallas_interpret(n):
    bits = np.random.default_rng(n).integers(0, 2, (9, n)).astype(np.int32)
    ref = jbitpack.pack_bits_words(jnp.asarray(bits), interpret=True)
    port = tbitpack.pack_bits_words(torch.from_numpy(bits))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).view(np.int32))
    np.testing.assert_array_equal(port.numpy(), tlow.pack_bit_rows(bits).view(np.int32))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_bitpack_matches_pallas_interpret(dtype):
    x = np.random.default_rng(7).normal(size=(8, 64)).astype(np.float32)
    x[0, :4] = (0.0, -0.0, -1e-30, 1e-30)
    x = (x * 4).astype(dtype)
    ref = jbitpack.bitpack(jnp.asarray(x), interpret=True)
    port = tbitpack.bitpack(torch.from_numpy(x))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).view(np.int32))


@pytest.mark.parametrize("k", [32, 64, 256])
def test_bitpack_bf16_matches_pallas_interpret(k):
    x = torch.randn((8, k), generator=torch.Generator().manual_seed(k)).to(torch.bfloat16)
    x[0, :4] = torch.tensor([0.0, -0.0, -1e-30, 1e-30])
    x[1, :2] = torch.tensor([float("nan"), float("-inf")])
    jx = jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16))
    ref = jbitpack.bitpack(jx, interpret=True)
    port = tbitpack.bitpack(x)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).view(np.int32))


def test_pack_rows_passes_bf16_to_bitpack_without_a_cast(monkeypatch):
    seen = []

    def spy(x):
        seen.append(x)
        return tbitpack.bitpack(x)

    monkeypatch.setattr(tops, "bitpack", spy)
    x = torch.randn((4, 96)).to(torch.bfloat16)
    tops._pack_rows(x)
    assert len(seen) == 1 and seen[0] is x


def test_bitpack_rejects_bad_input():
    with pytest.raises(ValueError):
        tbitpack.bitpack(torch.zeros((2, 33)))
    with pytest.raises(ValueError):
        tbitpack.bitpack(torch.zeros((2, 32), dtype=torch.float64))
    with pytest.raises(ValueError):
        tbitpack.pack_bits_words(torch.zeros((2, 3), dtype=torch.int64))
    assert tuple(tbitpack.pack_bits_words(torch.zeros((0, 40), dtype=torch.int32)).shape) == (0, 2)


# ---------------------------------------------------------------------------
# packed_layer
# ---------------------------------------------------------------------------

def _layer_case(seed, batch=40, n_out=9, n_words=3, pad=2):
    """Random words/weights/masks with ``pad`` never-firing pad neurons."""
    rng = np.random.default_rng(seed)
    u32 = lambda *shape: rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    words, weights, mask = u32(batch, n_words), u32(n_out, n_words), u32(n_out, n_words)
    thr = rng.integers(0, 32 * n_words + 2, n_out).astype(np.uint32)
    weights[-pad:], mask[-pad:], thr[-pad:] = 0, 0, 0xFFFFFFFF
    return words, weights, mask, thr


def _layer_reference(words, weights, mask, thr):
    agree = ~(words[:, None, :] ^ weights[None]) & mask[None]
    count = np.unpackbits(agree.view(np.uint8), axis=-1).reshape(*agree.shape, 32).sum((-1, -2))
    return (count >= thr[None].astype(np.int64)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_layer_plain_matches_reference(seed):
    case = _layer_case(seed)
    views = [torch.from_numpy(a.view(np.int32)) for a in case]
    out = tpl.packed_layer(*views)
    np.testing.assert_array_equal(out.numpy(), _layer_reference(*case))
    assert not out[:, -2:].any()  # pad neurons (thr 0xFFFFFFFF == -1 as int32) never fire


def test_packed_layer_rejects_bad_shapes():
    words, weights, mask, thr = (torch.from_numpy(a.view(np.int32)) for a in _layer_case(0))
    with pytest.raises(ValueError):
        tpl.packed_layer(words[:, :2], weights, mask, thr)
    with pytest.raises(ValueError):
        tpl.packed_layer(words, weights, mask, thr[:-1])
    with pytest.raises(ValueError):
        tpl.packed_layer(words.to(torch.int64), weights, mask, thr)
