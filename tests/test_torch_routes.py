"""Which kernel a CUDA launch takes: the route functions of the port's
``flash_attention``, ``bnn_matmul_mxu`` and ``bnn_matmul_packed`` wrappers.

Each wrapper picks one C entry point by a pure function of dtype, shape and
``data_ptr`` (never by trying one kernel and catching its failure), so the
choice is tested here on CPU tensors; nothing is launched.  The kernels on
each route are held against their plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import bnn_matmul as tpacked
from repro_torch.kernels import bnn_matmul_mxu as tmxu
from repro_torch.kernels import flash_attention as tflash


def _offset(shape, dtype, nbytes=2):
    """A contiguous CPU tensor of ``shape`` whose data starts ``nbytes``
    past a 16-byte boundary."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    numel = 1
    for n in shape:
        numel *= n
    buf = torch.zeros(numel + 16 // itemsize, dtype=dtype)
    skip = (16 - buf.data_ptr() % 16) % 16 + nbytes
    t = buf[skip // itemsize:skip // itemsize + numel].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == nbytes
    return t


def _qkv(d, dtype=torch.bfloat16, s=5):
    return [torch.zeros((2, s, d), dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("d", [8, 40, 64, 96, 128])
def test_flash_bf16_with_d_a_multiple_of_8_takes_tma(d):
    assert tflash.route(*_qkv(d)) == "tma"


@pytest.mark.parametrize("d", [1, 20, 100, 127])
def test_flash_bf16_with_ragged_d_takes_wmma(d):
    assert tflash.route(*_qkv(d)) == "wmma"


@pytest.mark.parametrize("d", [20, 64, 96])
def test_flash_float32_takes_f32(d):
    assert tflash.route(*_qkv(d, torch.float32)) == "f32"


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_misaligned_operand_takes_wmma(which):
    qkv = _qkv(96)
    qkv[which] = _offset(qkv[which].shape, torch.bfloat16)
    assert tflash.route(*qkv) == "wmma"


@pytest.mark.parametrize("k,n", [(8, 8), (72, 136), (3072, 8192), (520, 264)])
def test_mxu_bf16_with_k_and_n_multiples_of_8_takes_tma(k, n):
    x, w = torch.zeros((3, k), dtype=torch.bfloat16), torch.zeros((k, n), dtype=torch.bfloat16)
    assert tmxu.route(x, w) == "tma"


@pytest.mark.parametrize("k,n,dtype", [
    (513, 64, torch.bfloat16),   # ragged K
    (64, 130, torch.bfloat16),   # ragged N
    (64, 64, torch.float32),     # float32 x
])
def test_mxu_other_shapes_and_types_take_staged(k, n, dtype):
    x, w = torch.zeros((3, k), dtype=dtype), torch.zeros((k, n), dtype=torch.bfloat16)
    assert tmxu.route(x, w) == "staged"


@pytest.mark.parametrize("which", ["x", "w"])
def test_mxu_misaligned_operand_takes_staged(which):
    x = _offset((3, 64), torch.bfloat16) if which == "x" else torch.zeros((3, 64), dtype=torch.bfloat16)
    w = _offset((64, 72), torch.bfloat16) if which == "w" else torch.zeros((64, 72), dtype=torch.bfloat16)
    assert tmxu.route(x, w) == "staged"


def test_cpu_calls_launch_nothing_and_counts_keep_every_route():
    fa, mxu = tflash.flash_attention, tmxu.bnn_matmul_mxu
    assert set(fa.launches_by_route) == {"tma", "wmma", "f32"}
    assert set(mxu.launches_by_route) == {"tma", "staged"}
    before = (fa.launches, dict(fa.launches_by_route), mxu.launches, dict(mxu.launches_by_route))
    fa(*_qkv(64))
    mxu(torch.zeros((3, 64), dtype=torch.bfloat16), torch.zeros((64, 72), dtype=torch.bfloat16))
    assert (fa.launches, fa.launches_by_route, mxu.launches, mxu.launches_by_route) == before


def _words(m, kw):
    return torch.zeros((m, kw), dtype=torch.int32)


@pytest.mark.parametrize("m", [1, 2, 4, 8, 15, tpacked.STREAM_MAX_M])
@pytest.mark.parametrize("kw", [4, 96, 256, 768])
def test_packed_decode_sizes_take_stream(m, kw):
    assert tpacked.route(_words(m, kw), _words(3072, kw)) == "stream"


@pytest.mark.parametrize("m", [tpacked.STREAM_MAX_M + 1, 128, 2048])
def test_packed_rows_above_the_threshold_take_tiled(m):
    assert tpacked.route(_words(m, 96), _words(3072, 96)) == "tiled"


@pytest.mark.parametrize("kw", [1, 3, 97, 258])
def test_packed_kw_not_a_multiple_of_4_takes_tiled(kw):
    assert tpacked.route(_words(4, kw), _words(300, kw)) == "tiled"


def test_packed_x_too_large_for_shared_memory_takes_tiled():
    kw = 48 * 1024 // (4 * tpacked.STREAM_MAX_M)
    assert tpacked.route(_words(tpacked.STREAM_MAX_M, kw), _words(8, kw)) == "stream"
    assert tpacked.route(_words(tpacked.STREAM_MAX_M, kw + 4), _words(8, kw + 4)) == "tiled"


@pytest.mark.parametrize("which", ["x", "w"])
@pytest.mark.parametrize("nbytes", [4, 8, 12])
def test_packed_misaligned_operand_takes_tiled(which, nbytes):
    x = _offset((4, 96), torch.int32, nbytes) if which == "x" else _words(4, 96)
    w = _offset((300, 96), torch.int32, nbytes) if which == "w" else _words(300, 96)
    assert tpacked.route(x, w) == "tiled"


def test_packed_cpu_calls_launch_nothing():
    fn = tpacked.bnn_matmul_packed
    assert set(fn.launches_by_route) == {"stream", "tiled"}
    before = (fn.launches, dict(fn.launches_by_route))
    for m in (4, 100):
        out = fn(_words(m, 96), _words(300, 96), k_bits=3000)
        assert out.shape == (m, 300) and out.device.type == "cpu"
    assert (fn.launches, fn.launches_by_route) == before
