"""Peak rates of one NVIDIA H100 SXM at its 700 W power limit.

* Bytes: 3.35 TB/s of HBM3 (NVIDIA's H100 data sheet).
* 32-bit integer operations outside the tensor cores: 64 INT32 lanes per
  SM (Hopper architecture white paper) x 132 SMs x 1.98 GHz boost clock.
* Population counts: 16 results per SM per clock on compute capability 9.0
  (CUDA C++ Programming Guide, arithmetic instruction throughput table).
* Dense bf16 on the tensor cores: 989 TFLOP/s (H100 SXM data sheet).
* Dense int8 on the tensor cores: 1,979 TOP/s (H100 SXM data sheet).
* float32 outside the tensor cores (FFMA, no TF32): 66.9 TFLOP/s (H100
  SXM data sheet, "FP32").

A card set below 700 W runs slower under load; a bound against these
peaks is stated beside the card's power limit.
"""

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
POPC_PER_S = 16 * 132 * 1.98e9
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12
FP32_FLOPS = 66.9e12
