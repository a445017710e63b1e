"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and skips
where ``torch.cuda.is_available()`` is false.  The file imports neither JAX
nor the reference package, so it also runs on a GPU machine without them::

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  Bit-exact
throughout.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import bitops, compiler, pipeline
from repro_torch.dataplane import executor, traffic
from repro_torch.kernels import bitpack, optable_exec, packed_layer

TABLES = ("opcode", "dst", "src0", "src1", "imm0", "imm1", "mask", "first_write")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _lowered(sizes, native_popcnt=False, seed=0):
    rng = np.random.default_rng(seed)
    params = [
        rng.integers(0, 2, (sizes[i + 1], sizes[i])).astype(np.int32)
        for i in range(len(sizes) - 1)
    ]
    chip = pipeline.RMT_NATIVE_POPCNT if native_popcnt else pipeline.RMT
    return compiler.compile_bnn(params, chip).lower()


@pytest.mark.parametrize(
    "sizes,native", [((32, 64, 32), False), ((32, 64, 32), True), ((128, 64, 32, 2), False)]
)
@pytest.mark.parametrize("batch", [1, 1000])
def test_optable_kernel_matches_plain(cuda, sizes, native, batch):
    lp = _lowered(sizes, native, seed=5)
    rng = np.random.default_rng(6)
    regs = rng.integers(0, 1 << 32, (lp.num_regs, batch), dtype=np.uint64)
    regs[-1] = 0  # the null register
    regs = bitops.u32_to_i32(torch.from_numpy(regs.astype(np.int64))).to(cuda)
    tables = tuple(executor._i32(getattr(lp, n)).to(cuda) for n in TABLES)
    before = optable_exec.optable_run.launches
    out = optable_exec.optable_run(regs, *tables)
    torch.cuda.synchronize()
    assert optable_exec.optable_run.launches == before + 1
    assert torch.equal(out, optable_exec.optable_run_plain(regs, *tables))


def test_optable_kernel_rejects_malformed_tables(cuda):
    lp = _lowered((5, 3))
    tables = [executor._i32(getattr(lp, n)).to(cuda) for n in TABLES]
    tables[0][0, 0] = 6
    with pytest.raises(ValueError):
        optable_exec.optable_run(torch.zeros((lp.num_regs, 4), dtype=torch.int32, device=cuda), *tables)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100])
def test_bitpack_kernels_match_plain(cuda, n):
    gen = torch.Generator().manual_seed(n)
    bits = torch.randint(0, 2, (777, n), generator=gen, dtype=torch.int32).to(cuda)
    assert torch.equal(bitpack.pack_bits_words(bits), bitpack.pack_ge_plain(bits, 1))
    x = torch.randn((300, 32 * (1 + n // 32)), generator=gen).to(cuda)
    assert torch.equal(bitpack.bitpack(x), bitpack.pack_ge_plain(x, 0))
    xi = torch.randint(-5, 5, (300, 64), generator=gen, dtype=torch.int32).to(cuda)
    assert torch.equal(bitpack.bitpack(xi), bitpack.pack_ge_plain(xi, 0))


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_layer_kernel_matches_plain(cuda, seed):
    rng = np.random.default_rng(seed)
    u32 = lambda *shape: rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    words, weights, mask = u32(5000, 3), u32(9, 3), u32(9, 3)
    thr = rng.integers(0, 98, 9).astype(np.uint32)
    weights[-2:], mask[-2:], thr[-2:] = 0, 0, 0xFFFFFFFF  # pad neurons
    args = [torch.from_numpy(a.view(np.int32)).to(cuda) for a in (words, weights, mask, thr)]
    out = packed_layer.packed_layer(*args)
    assert torch.equal(out, packed_layer.packed_layer_plain(*args))
    assert not out[:, -2:].any()


@pytest.mark.parametrize("backend,scan_hops", [("jnp", False), ("packed", False), ("packed", True)])
def test_execute_on_cuda_matches_cpu(cuda, backend, scan_hops):
    lp = _lowered((32, 64, 32), seed=7)
    packets = traffic.generate("ddos_burst", 5000, 32, seed=2)
    cpu = executor.execute(lp, packets, backend=backend, scan_hops=scan_hops, device="cpu")
    gpu = executor.execute(lp, packets, backend=backend, scan_hops=scan_hops, chunk_size=2048)
    np.testing.assert_array_equal(gpu, cpu)
