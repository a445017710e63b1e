"""Compulsory bytes and operations of each of the port's CUDA kernels, as
functions of the shapes (and tables) of one call.

Bytes count each input read once and each output written once, whatever a
kernel reads again; operations count what the call's inputs need, at the
peak rate of their kind (``hw``).  :meth:`Cost.bound_ms` is the least time
the card could take: the larger of bytes over the memory rate and
operations over their rate.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline import hw


def words(bits: int) -> int:
    """uint32 words that hold ``bits`` packed bits."""
    return -(-bits // 32)


@dataclasses.dataclass(frozen=True)
class Cost:
    """Bytes and operations of one call; ``rate`` is the peak of its
    operations' kind.  Costs of one rate add, and scale by a count of
    calls."""

    bytes: int
    ops: int
    rate: float = hw.INT32_OPS_PER_S

    def __add__(self, other: "Cost") -> "Cost":
        if other.rate != self.rate:
            raise ValueError("costs of operations at different rates do not add")
        return Cost(self.bytes + other.bytes, self.ops + other.ops, self.rate)

    def __mul__(self, calls: int) -> "Cost":
        return Cost(self.bytes * calls, self.ops * calls, self.rate)

    __rmul__ = __mul__

    def bound_ms(self) -> tuple[float, str]:
        """Least milliseconds on the card and what sets them: ``"bytes"``
        or ``"operations"``."""
        t_bytes, t_ops = self.bytes / hw.HBM_BYTES_PER_S, self.ops / self.rate
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def total(costs) -> Cost:
    """The sum of one or more costs of one rate."""
    costs = iter(costs)
    out = next(costs)
    for c in costs:
        out = out + c
    return out


def optable_run(num_regs: int, batch: int, num_ops: int, records_bytes: int) -> Cost:
    """One program over ``batch`` packets, whatever the route: the register
    file read and written once and the plan's records read once; an ALU
    operation, the mask and the write-back per true row."""
    return Cost(2 * num_regs * batch * 4 + records_bytes, 3 * num_ops * batch)


def bitpack(rows: int, cols: int, itemsize: int = 4) -> Cost:
    """``bitpack`` / ``pack_bits_words``: (rows, cols) elements of
    ``itemsize`` bytes read, (rows, words(cols)) uint32 written; one
    compare per element."""
    return Cost(rows * cols * itemsize + rows * words(cols) * 4, rows * cols)


def packed_layer(batch: int, n_words: int, n_out: int) -> Cost:
    """``packed_layer``: (batch, n_words) words, weights and masks
    (n_out, n_words), thresholds (n_out,) read; (batch, n_out) bits
    written.  Per output: xor, not, and, popcount and add per word, and the
    compare."""
    return Cost((batch * n_words + 2 * n_out * n_words + n_out + batch * n_out) * 4,
                batch * n_out * (5 * n_words + 1))


def packed_layer_popcounts(batch: int, n_words: int, n_out: int) -> int:
    """The population counts among :func:`packed_layer`'s operations."""
    return batch * n_out * n_words


def packed_layer_routed(batch: int, n_words: int, tenants: int, n_out: int) -> Cost:
    """``packed_layer_routed``: as :func:`packed_layer`, plus the (batch,)
    tenant ids, over (tenants, n_out, n_words) tables."""
    return Cost((batch * n_words + batch + batch * n_out + 2 * tenants * n_out * n_words
                 + tenants * n_out) * 4,
                batch * n_out * (5 * n_words + 1))


def bnn_matmul_packed(m: int, n: int, kw: int) -> Cost:
    """The ±1 GEMM on packed words: (m, kw) and (n, kw) words read, (m, n)
    int32 written; 2 m n kw 32 operations at the int8 tensor cores' rate,
    the fastest exact way the card has to do them (each bit a +1/-1 int8,
    products summed in int32), whatever route a launch takes."""
    return Cost((m * kw + n * kw + m * n) * 4, 2 * m * n * kw * 32, hw.INT8_TENSOR_OPS)


def bnn_matmul_packed_experts(e: int, c: int, o: int, kw: int) -> Cost:
    """The ±1 GEMM of every expert on packed words: (e, c, kw) and
    (e, o, kw) words read, (e, c, o) int32 written; 2 e c o kw 32 int8
    tensor-core operations.  Every capacity slot counts, empty ones too:
    the kernel computes them, as the reference does."""
    return Cost((e * c * kw + e * o * kw + e * c * o) * 4, 2 * e * c * o * kw * 32, hw.INT8_TENSOR_OPS)


def bnn_matmul_mxu(m: int, k: int, n: int) -> Cost:
    """The ±1 GEMM on the tensor cores: (m, k) and (k, n) bf16 read, (m, n)
    float32 written; 2mnk bf16 operations."""
    return Cost((m * k + k * n) * 2 + m * n * 4, 2 * m * n * k, hw.BF16_TENSOR_FLOPS)


def flash_attention(bh: int, s: int, d: int, causal: bool = True) -> Cost:
    """Attention over (bh, s, d) bf16: q, k, v read and o written; the 4
    s^2 d operations of both products, the causal half of them when
    ``causal``."""
    ops = 4 * bh * s * s * d
    return Cost(4 * bh * s * d * 2, ops // 2 if causal else ops, hw.BF16_TENSOR_FLOPS)


def causal_pairs(s_q: int, s_k: int) -> int:
    """(query, key) pairs a causal mask keeps: query i sees keys 0..i of
    ``s_k``."""
    full = min(s_q, s_k)            # rows i < s_k see i + 1 keys
    return full * (full + 1) // 2 + (s_q - full) * s_k


def chunked_attention(b: int, s_q: int, s_k: int, h: int, kvh: int, dqk: int, dv: int, causal: bool,
                      itemsize: int = 2) -> Cost:
    """Softmax attention of (b, s_q, h, dqk) queries over (b, s_k, kvh, dqk)
    keys and (b, s_k, kvh, dv) values: q, k, v read and the (b, s_q, h, dv)
    output written once, in their type; 2 (dqk + dv) operations a (query,
    key) pair of each head, the causal pairs only when ``causal``, on the
    bf16 tensor cores (float32 inputs: the CUDA cores' float32 rate).  A
    second pass of the QK product is a design's cost, not the function's."""
    pairs = causal_pairs(s_q, s_k) if causal else s_q * s_k
    moved = (b * s_q * h * (dqk + dv) + b * s_k * kvh * (dqk + dv)) * itemsize
    rate = hw.BF16_TENSOR_FLOPS if itemsize == 2 else hw.FP32_FLOPS
    return Cost(moved, 2 * b * h * pairs * (dqk + dv), rate)


def decode_attention(b: int, keys: int, h: int, kvh: int, d: int, dv: int, itemsize: int = 2) -> Cost:
    """One decode position's attention over ``keys`` positions (the cache
    up to ``index`` and, incremental, the new column): q (b, h, d) read,
    each of the ``keys`` K and V rows of every (b, kv head) read once in
    its type, the (b, h, dv) output written; 2 (d + dv) float32 operations
    a key of each head, on the CUDA cores."""
    moved = (b * h * (d + dv) + b * keys * kvh * (d + dv)) * itemsize
    return Cost(moved, 2 * b * h * keys * (d + dv), hw.FP32_FLOPS)
