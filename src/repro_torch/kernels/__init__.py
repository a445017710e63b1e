"""Hand-written CUDA kernels for Hopper (``sm_90a``), one module each.

Every module holds the kernel's wrapper, its plain PyTorch version, and a
``launches`` count on the wrapper.  A wrapper runs the plain version for CPU
tensors and launches the kernel (or raises) for CUDA tensors.  Sources live
in ``repro_torch/csrc`` and are built by ``kernels._build`` at first use.

  optable_exec    — the op-table ALU of the dataplane executor
  bitpack         — sign / {0,1} bits -> packed uint32 words
  packed_layer    — XNOR-popcount-threshold layer of the packed backend, and
                    its per-tenant form for the multi-tenant scheduler
  bnn_matmul      — packed XNOR-popcount GEMM (the LM's packed projections)
  bnn_matmul_mxu  — ±1 binary GEMM on the tensor cores
  flash_attention — fused online-softmax attention

``ref`` holds the binary GEMMs' plain oracles and ``ops`` the public
binary-GEMM ops that dispatch between them and the kernels.
"""
