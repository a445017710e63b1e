"""Which kernel a CUDA launch takes: the route functions of the port's
``flash_attention``, ``bnn_matmul_mxu``, ``bnn_matmul_packed``, ``bitpack``
(and ``pack_bits_words``), ``packed_layer``, ``packed_layer_routed`` and
``optable_run`` wrappers.

Each wrapper picks one C entry point by a pure function of dtype, shape and
``data_ptr`` (never by trying one kernel and catching its failure), so the
choice is tested here on CPU tensors and host plans; nothing is launched.  The kernels on
each route are held against their plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.n2net_paper import FIVE_TUPLE, HEADLINE
from repro_torch.core import bnn as tbnn
from repro_torch.core import compiler as tcompiler
from repro_torch.core import pipeline as tpipe
from repro_torch.dataplane import executor as texec
from repro_torch.dataplane import lowering as tlow
from repro_torch.dataplane.multitenant import SwitchScheduler
from repro_torch.kernels import _build
from repro_torch.kernels import bitpack as tbitpack
from repro_torch.kernels import bnn_matmul as tpacked
from repro_torch.kernels import bnn_matmul_mxu as tmxu
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import optable_exec as topt
from repro_torch.kernels import packed_layer as tlayer


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
    # Every shape that took the first design's tiled route takes mma.
    assert tpacked.route(_words(m, 96), _words(3072, 96)) == "mma"


@pytest.mark.parametrize("kw", [1, 3, 97, 258])
def test_packed_kw_not_a_multiple_of_4_takes_tiled(kw):
    assert tpacked.route(_words(4, kw), _words(300, kw)) == "mma"


def test_packed_x_too_large_for_shared_memory_takes_tiled():
    kw = 48 * 1024 // (4 * tpacked.STREAM_MAX_M)
    assert tpacked.route(_words(tpacked.STREAM_MAX_M, kw), _words(8, kw)) == "stream"
    assert tpacked.route(_words(tpacked.STREAM_MAX_M, kw + 4), _words(8, kw + 4)) == "mma"


@pytest.mark.parametrize("which", ["x", "w"])
@pytest.mark.parametrize("nbytes", [4, 8, 12])
def test_packed_misaligned_operand_takes_tiled(which, nbytes):
    x = _offset((4, 96), torch.int32, nbytes) if which == "x" else _words(4, 96)
    w = _offset((300, 96), torch.int32, nbytes) if which == "w" else _words(300, 96)
    assert tpacked.route(x, w) == "mma"


@pytest.mark.parametrize("m", [1, 4, 16, 17, 128, 2048, 131072])
@pytest.mark.parametrize("kw", [1, 5, 96, 256])
def test_packed_route_never_returns_tiled(m, kw):
    """The first design is reached only through ``_launch(..., "tiled")``."""
    x = torch.zeros((1, kw), dtype=torch.int32).expand(m, kw)  # route reads shape and data_ptr
    got = tpacked.route(x, _words(8, kw))
    assert got in ("stream", "mma")
    assert got == ("stream" if m <= tpacked.STREAM_MAX_M and kw % 4 == 0 else "mma")


def test_packed_cpu_calls_launch_nothing():
    fn = tpacked.bnn_matmul_packed
    assert set(fn.launches_by_route) == {"stream", "mma", "tiled"}
    before = (fn.launches, dict(fn.launches_by_route))
    for m in (4, 100):
        out = fn(_words(m, 96), _words(300, 96), k_bits=3000)
        assert out.shape == (m, 300) and out.device.type == "cpu"
    assert (fn.launches, fn.launches_by_route) == before


# bitpack / pack_bits_words: 16-byte loads when a row is a whole number of
# 16-byte vectors (4 float32 or int32, 8 bf16) and the input is aligned.
WIDTHS = [1, 4, 8, 31, 32, 33, 64, 100, 2048]


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16])
def test_bitpack_route_by_width_and_type(n, dtype):
    per_load = 8 if dtype == torch.bfloat16 else 4
    want = "vec" if n % per_load == 0 else "scalar"
    assert tbitpack.route(torch.zeros((3, n), dtype=dtype)) == want


@pytest.mark.parametrize("nbytes", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16])
def test_bitpack_misaligned_input_takes_scalar(nbytes, dtype):
    assert tbitpack.route(_offset((3, 64), dtype, nbytes)) == "scalar"


def test_bitpack_cpu_calls_launch_nothing():
    fns = (tbitpack.bitpack, tbitpack.pack_bits_words)
    for fn in fns:
        assert set(fn.launches_by_route) == {"vec", "scalar"}
        assert set(fn.launches_by_dtype) == {"float32", "bfloat16", "int32"}
    before = [(fn.launches, dict(fn.launches_by_route), dict(fn.launches_by_dtype)) for fn in fns]
    for dtype in (torch.float32, torch.int32, torch.bfloat16):
        assert tbitpack.bitpack(torch.zeros((3, 64), dtype=dtype)).device.type == "cpu"
    tbitpack.pack_bits_words(torch.zeros((3, 33), dtype=torch.int32))
    assert [(fn.launches, fn.launches_by_route, fn.launches_by_dtype) for fn in fns] == before


# packed_layer: 4 neurons a thread when n_out % 4 == 0 (up to QUAD_MAX_OUT)
# and a packet's words (1, 2 or 4) load as one aligned vector.
def _layer(n_out, n_words):
    return torch.zeros((n_out, n_words), dtype=torch.int32)


@pytest.mark.parametrize("n_out", [2, 4, 32, 64])
@pytest.mark.parametrize("n_words", [1, 2, 4, 5])
def test_packed_layer_route_by_shape(n_out, n_words):
    want = "quad" if n_out % 4 == 0 and n_words in (1, 2, 4) else "general"
    assert tlayer.route(torch.zeros((7, n_words), dtype=torch.int32), _layer(n_out, n_words)) == want


def test_packed_layer_wide_layers_take_general():
    words = torch.zeros((7, 2), dtype=torch.int32)
    assert tlayer.route(words, _layer(tlayer.QUAD_MAX_OUT, 2)) == "quad"
    assert tlayer.route(words, _layer(tlayer.QUAD_MAX_OUT + 4, 2)) == "general"


# A packet's words load as one 4 * n_words-byte vector: a view misaligned by
# 4 bytes still takes quad at one word, by 8 bytes at up to two.
@pytest.mark.parametrize("nbytes,n_words,want", [
    (4, 1, "quad"), (4, 2, "general"), (4, 4, "general"),
    (8, 1, "quad"), (8, 2, "quad"), (8, 4, "general"),
])
def test_packed_layer_misaligned_words(nbytes, n_words, want):
    words = _offset((7, n_words), torch.int32, nbytes)
    assert tlayer.route(words, _layer(32, n_words)) == want


# Tables past one block's shared memory ((2 * n_out * n_words + n_out) * 4
# bytes over 232,448) take the tiled GEMM: 916 x 32 words is the
# block-diagonal layer of 32 merged tenants, 3540 x 128 and 1510 x 150 those
# of 128 (misaligned views too).
@pytest.mark.parametrize("n_out,n_words", [(916, 32), (1030, 29), (600, 48), (3540, 128), (1510, 150)])
def test_packed_layer_tables_past_shared_memory_take_tiled(n_out, n_words):
    assert (2 * n_out * n_words + n_out) * 4 > _build.MAX_SHARED_BYTES
    assert tlayer.route(torch.zeros((7, n_words), dtype=torch.int32), _layer(n_out, n_words)) == "tiled"
    words = _offset((7, n_words), torch.int32, 4)
    assert tlayer.route(words, _layer(n_out, n_words)) == "tiled"


def test_packed_layer_general_up_to_shared_memory():
    """``(2 * 33 + 1) * 4 * n_out`` bytes at 33 words: 867 neurons fit
    232,448 B, 868 do not."""
    words = torch.zeros((7, 33), dtype=torch.int32)
    assert tlayer.route(words, _layer(867, 33)) == "general"
    assert tlayer.route(words, _layer(868, 33)) == "tiled"


def test_packed_layer_cpu_calls_launch_nothing():
    fn = tlayer.packed_layer
    assert set(fn.launches_by_route) == {"quad", "general", "tiled", "cached"}
    before = (fn.launches, dict(fn.launches_by_route))
    for n_out, n_words in ((32, 2), (2, 1), (9, 5), (916, 32)):
        out = fn(torch.zeros((7, n_words), dtype=torch.int32), _layer(n_out, n_words),
                 _layer(n_out, n_words), torch.zeros(n_out, dtype=torch.int32))
        assert out.shape == (7, n_out) and out.device.type == "cpu"
    assert (fn.launches, fn.launches_by_route) == before


# packed_layer_routed: 4 neurons a thread when the stacked layer has n_out %
# 4 == 0 (up to QUAD_MAX_OUT), 1, 2 or 4 words aligned to a packet's row,
# and tables aligned to 16 bytes (4 neurons' rows are one vector load).
def _stack(tenants, n_out, n_words):
    return (torch.zeros((tenants, n_out, n_words), dtype=torch.int32),
            torch.zeros((tenants, n_out, n_words), dtype=torch.int32),
            torch.zeros((tenants, n_out), dtype=torch.int32))


@pytest.mark.parametrize("tenants", [1, 8, 128])
@pytest.mark.parametrize("n_out,n_words", [(64, 1), (32, 2), (4, 4), (1024, 4)])
def test_packed_layer_routed_quad_shapes(tenants, n_out, n_words):
    w, m, thr = _stack(tenants, n_out, n_words)
    assert tlayer.routed_route(torch.zeros((7, n_words), dtype=torch.int32), w, m, thr) == "quad"


@pytest.mark.parametrize("n_out,n_words", [(5, 1), (13, 2), (66, 4), (64, 3), (32, 8), (1028, 1)])
def test_packed_layer_routed_other_shapes_take_general(n_out, n_words):
    w, m, thr = _stack(3, n_out, n_words)
    assert tlayer.routed_route(torch.zeros((7, n_words), dtype=torch.int32), w, m, thr) == "general"


@pytest.mark.parametrize("which", ["words", "weights", "mask", "thresholds"])
def test_packed_layer_routed_misaligned_view_takes_general(which):
    ops = {"words": torch.zeros((7, 2), dtype=torch.int32)}
    ops["weights"], ops["mask"], ops["thresholds"] = _stack(3, 32, 2)
    assert tlayer.routed_route(*ops.values()) == "quad"
    ops[which] = _offset(tuple(ops[which].shape), torch.int32, 4)
    assert tlayer.routed_route(*ops.values()) == "general"


def test_packed_layer_routed_cpu_calls_launch_nothing():
    fn = tlayer.packed_layer_routed
    assert set(fn.launches_by_route) == {"quad", "general"}
    before = (fn.launches, dict(fn.launches_by_route))
    for n_out, n_words in ((32, 2), (5, 3)):
        w, m, thr = _stack(3, n_out, n_words)
        words, ids = torch.zeros((7, n_words), dtype=torch.int32), torch.arange(7, dtype=torch.int32) % 3
        out = fn(words, ids, w, m, thr)
        assert out.shape == (7, n_out) and out.device.type == "cpu"
    assert (fn.launches, fn.launches_by_route) == before


def test_packed_layer_routed_checks_ids_on_the_cpu():
    """The public wrapper and the scheduler's dispatch, which skips the
    read back on the card, both refuse an id outside [0, T) on the CPU."""
    w, m, thr = _stack(3, 32, 2)
    words = torch.zeros((7, 2), dtype=torch.int32)
    dispatch = texec.routed_packed_stacked_fn([t.lowered for t in _pool(8).tenants], device="cpu")
    for bad in (3, -1):
        ids = torch.zeros(7, dtype=torch.int32)
        ids[4] = bad
        with pytest.raises(ValueError, match=r"outside \[0, 3\)"):
            tlayer.packed_layer_routed(words, ids, w, m, thr)
    for bad in (8, -1):
        ids = torch.zeros(7, dtype=torch.int32)
        ids[4] = bad
        with pytest.raises(ValueError, match=r"outside \[0, 8\)"):
            dispatch(torch.zeros((7, 64), dtype=torch.int32), ids)


# optable_run: the shared route while a packet's registers and scratch rows
# (and the block's two staged elements) fit shared memory at 32 packets a
# block, else the split route while 4 packets' registers and a value per
# chain of an element do, else the global route.
TABLES = ("opcode", "dst", "src0", "src1", "imm0", "imm1", "mask", "first_write")
TENANT_SHAPES = [(32, 64, 32), (16, 32, 8), (32, 16), (8, 12, 6), (16, 8, 4), (32, 32, 4)]


def _paper_plan(spec, seed):
    params = tbnn.init_params(spec, torch.Generator().manual_seed(seed))
    lp = tcompiler.compile_bnn([w.numpy() for w in params], tpipe.RMT).lower()
    return topt.make_plan(*(getattr(lp, n) for n in TABLES), lp.num_regs), lp.num_regs


@functools.lru_cache(maxsize=None)
def _pool(count):
    """``benchmarks/multitenant_bench.py``'s pool of ``count`` tenants (its
    six shapes in turn, weights from a seed) admitted in merged mode."""
    rng = np.random.default_rng(count)
    progs = []
    for i in range(count):
        shape = TENANT_SHAPES[i % len(TENANT_SHAPES)]
        progs.append(tcompiler.compile_bnn(
            [rng.integers(0, 2, (shape[j + 1], shape[j])).astype(np.int32) for j in range(len(shape) - 1)]))
    chip = tpipe.ChipSpec(
        num_elements=sum(p.num_elements for p in progs) + 1, phv_bits=sum(p.peak_phv_bits for p in progs),
        max_parallel_ops=max(tpipe.MAX_FIELDS, tlow.peak_stage_rows([tlow.lower_program(p) for p in progs])),
        name="shared")
    sched = SwitchScheduler(chip, mode="merged")
    for i, p in enumerate(progs):
        sched.admit(p, name=f"t{i}")
    return sched


def _merged_plan(count, layout):
    """The plan of the pool's merged op-table in ``layout``, and its
    register count."""
    lp = _pool(count).merged(layout).lowered
    return topt.make_plan(*(getattr(lp, n) for n in TABLES), lp.num_regs), lp.num_regs


@pytest.mark.parametrize("spec,seed", [(HEADLINE, 0), (FIVE_TUPLE, 1)])
def test_optable_paper_models_take_shared(spec, seed):
    assert topt.route(*_paper_plan(spec, seed)) == "shared"


@pytest.mark.parametrize("layout", ["interleave", "concat"])
def test_optable_eight_tenant_merge_takes_shared(layout):
    plan, num_regs = _merged_plan(8, layout)
    assert num_regs == 521 and topt.route(plan, num_regs) == "shared"


@pytest.mark.parametrize("layout,scratch", [("interleave", 916), ("concat", 64)])
def test_optable_thirty_two_tenant_merge_takes_split(layout, scratch):
    plan, num_regs = _merged_plan(32, layout)
    assert (num_regs, plan.max_deferred) == (1833, scratch)
    assert topt.route(plan, num_regs) == "split"
    with pytest.raises(ValueError, match="1833 registers"):  # a forced shared launch cannot fit
        topt.plan_threads(plan, num_regs)


def _one_row_plan(num_regs):
    """One element of one XOR row (padded to a group of ROW_GROUP records)
    over ``num_regs`` registers: no scratch, 2 x 33 staged records a block."""
    t = {n: np.zeros((1, 1), np.int32) for n in TABLES}
    t["dst"][:] = 1
    t["first_write"][:] = 1
    t["mask"] = np.full((1, 1), 0xFFFFFFFF, np.uint32)
    return topt.make_plan(*(t[n] for n in TABLES), num_regs)


def test_optable_synthetic_file_just_past_the_limit_takes_global():
    """At 32 packets a block a register costs 128 B of shared memory beside
    the 2 x 33 x 16 B of staged records: 1,807 registers fit 232,448 B,
    1,808 do not and take the split route, where a register and a chain's
    value cost 16 B each at 4 packets a block: up to 14,527 registers with
    the one row's chain; past that, the global route."""
    fits = (_build.MAX_SHARED_BYTES - 2 * 33 * 16) // (4 * 32)
    assert fits == 1807
    split = _build.MAX_SHARED_BYTES // 16 - 1
    assert split == 14527
    for num_regs, want in ((fits, "shared"), (fits + 1, "split"), (split, "split"), (split + 1, "global"),
                           (60000, "global")):
        plan = _one_row_plan(num_regs)
        assert plan.stride == 33 and plan.max_deferred == 0 and plan.max_chains == 1
        assert topt.route(plan, num_regs) == want


def test_optable_global_threads_spread_small_batches():
    assert topt.global_threads(1024, 132) == 32
    assert topt.global_threads(32768, 132) == 128
    assert topt.global_threads(1 << 20, 132) == 256
    assert topt.global_threads(1, 132) == 32


def test_optable_cpu_calls_launch_nothing():
    fn = topt.optable_run
    assert set(fn.launches_by_route) == {"shared", "split", "global"}
    before = (fn.launches, dict(fn.launches_by_route))
    plan = _one_row_plan(4)
    t = {n: torch.zeros((1, 1), dtype=torch.int32) for n in TABLES}
    t["dst"][:] = 1
    out = fn(torch.ones((4, 3), dtype=torch.int32), *(t[n] for n in TABLES))
    assert out.device.type == "cpu" and plan.rows.tolist() == [1]
    assert (fn.launches, fn.launches_by_route) == before
