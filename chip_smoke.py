"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

What it does, in order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the port's CUDA kernels from this checkout and prints the build time;
3. holds every kernel of the packet path against its plain PyTorch version on
   the card, bit for bit (``torch.equal``), at the shapes the main path gives
   it: ``optable_run`` on the headline model's tables for the default and the
   native-popcount chip (all six opcodes) and on FIVE_TUPLE's (the largest
   register file), each timed, every launch on the ``shared`` route; the
   ``split`` and ``global`` routes, forced, on the same three, timed in
   turns with ``shared`` on HEADLINE and FIVE_TUPLE; ``pack_bits_words`` and ``bitpack`` on both
   routes (``vec`` and ``scalar``: ragged widths, misaligned views), float32
   and bf16 with planted subnormal signs, bf16 at the LM's decode and
   scoring shapes; ``packed_layer`` on its routes (``quad``, ``general``,
   ``tiled`` and ``cached``, forced) on the headline model's and FIVE_TUPLE's layers
   and their scan plans' pad neurons.  Each launch asserts its route.  The
   two kernels are timed per chunk as the device time of a replayed CUDA
   graph of 16 chunks, the new route in turns with the first design
   (``scalar``, ``general``; and ``tiled``, ``cached``) and with one packet (the
   launches' fixed cost), and back to
   back with events; bf16 ``bitpack`` as a graph of one decode layer's seven
   launches (in turns with the float32 cast and launch it replaced) and at
   the scoring shapes, over inputs larger than the L2 cache;
4. drives the main path: the headline model (``BnnSpec((32, 64, 32))``,
   weights from a fixed seed) streams 2**20 ``ddos_burst`` packets at chunk
   32768 through ``execute_stream`` with the op-table backend and with the
   packed backend.  The launch count of every kernel is zeroed just before
   and read just after each run; the packed backend's launches must all take
   the ``vec`` and ``quad`` routes.  The two outputs must agree on every
   packet, and on the first chunk with the port's interpreter and the BNN
   oracle;
5. the switch fabric: FIVE_TUPLE (``BnnSpec((128, 64, 32, 2))``, weights
   from a fixed seed) compiled for the RMT chip partitions into 4 hops; in
   the ``multi_hop`` and ``recirculate`` modes, 2**20 ``ddos_burst``
   packets at chunk 32768 run through ``SwitchFabric.run`` on three paths
   (the op-table backend over the stacked hops, the op-table backend hop by
   hop, the packed backend), each bit-exact with ``executor.execute`` of the
   unsliced program on every packet and, on the first chunk, with the
   interpreter and the BNN oracle; ``optable_run`` launches hops x (chunks
   + 1) times a run, the packed kernels layers x (chunks + 1); the unsliced
   program through ``execute_stream`` (one switch) is the baseline;
6. fleets of switches, on ``benchmarks/fleet_bench.py``'s workload (the
   headline model, per-stream chunks of 16 packets, 20 blocks): ``optable_run``
   (``shared``), ``pack_bits_words`` (``vec``) and ``packed_layer`` (each
   layer's route) held against their plain versions at a fleet block of 64
   and of 10,240 streams (1,024 and 163,840 packets) and timed there with
   their bounds; then, as the benchmark times them (replicas of one 320 x 32
   array of uniform bits, each run twice and the second timed), one stream
   through ``execute_stream`` at chunk 16 and ``execute_fleet`` at 4 to
   10,240 streams on the packed backend, at 64 and 10,240 on the op-table
   backend, each run's launches exactly its path's (a block and the warm
   call: a ``pack_bits_words`` and a ``packed_layer`` a layer, or one
   ``optable_run``), with ingest (``fleet_blocks``), execute and the rest of
   the call timed apart; distinct streams of unequal lengths (uniform bits
   seeded by stream index, one empty) at 64 and 10,240 streams on both
   backends, directly and through ``plan.run``, every stream bit-exact with
   one ``executor.execute`` over all streams' packets and, on the first
   block, with the interpreter and the BNN oracle, its count and the bit
   counts those of its outputs; ``FleetEngine`` over the same streams (with
   observability on and an SLO set: its ``health()`` printed, its bound the
   probe's) and over replicas, timed, no ``fleet-ingest`` thread left alive.
   Every run prints its ``roofline.dataplane`` bound and the fraction of it
   reached, which must be in (0, 1] (so must the main path's two runs);
7. train -> export -> deploy: ``BnnTrainer(BnnTrainConfig())`` (the default
   ``(32, 128, 64, 1)`` model, 600 steps of batch 512, ``iot_telemetry``
   against ``ddos_burst``) trains on the card to at least 90% held-out
   accuracy, exports, and ``verify_roundtrip`` over a 5-hop ``multi_hop``
   fabric (op-table and packed backends) finds no packet where the oracle,
   the executor, the fabric and the trainer's own forward bits disagree;
8. multi-tenant switch scheduling (``SwitchScheduler``), on the tenant pool
   of ``benchmarks/multitenant_bench.py`` (six BNN shapes repeated, weights
   from fixed seeds, built by ``build_fleet`` as ``program=`` tenants, whose
   shared chip must be the one sized there), 2**20 mixed packets
   arriving in chunks of 1024 (``quantum`` 1024):
   a. 8 tenants in ``merged``/``interleave``, ``merged``/``concat`` and
      ``time_sliced``, each on the packed and the op-table backend; 128
      tenants in ``merged``/``interleave`` on the packed backend (the
      per-tenant ``packed_layer_routed`` kernel).  Every tenant's served
      packets are bit-exact with its own ``executor.execute`` on the card,
      and on the first chunk with the interpreter and the BNN oracle; per
      tenant ``packets == served + dropped`` with no drop; each run's
      launches are counted from zero and must be the ones its path makes,
      every ``optable_run`` launch on the ``shared`` route, every
      ``packed_layer_routed`` launch on ``quad`` and each ``packed_layer``
      launch on its layer's route;
   b. 32 tenants (1,833 merged registers, past the ``shared`` route) in
      ``merged``/``interleave`` and ``merged``/``concat`` on the op-table
      backend, every launch on the ``split`` route, and on the packed
      backend beside them (the ``concat`` merge's 916 x 32-word layer on
      ``packed_layer``'s ``tiled`` route); 128 tenants (7,081 registers) in
      ``merged``/``interleave`` on the op-table backend (``split``); each
      tenant bit-exact as in a;
   c. three tenants, one replaying a synthetic capture written as pcap and
      pcapng and read back, in ``merged`` and ``time_sliced`` on both
      backends; the capture tenant is bit-exact with its BNN oracle.
   Before the runs, ``packed_layer_routed`` is held against its plain version
   on the 8-, 32- and 128-tenant stacks at chunks of 1024 and 32768 on both
   routes (``quad``, ``general``; timed there in turns as a replayed graph
   of 16 chunks), and every merged program that a run serves against its
   plain versions: ``optable_run`` on the 8-tenant merges (``shared``), on
   both 32-tenant layouts at chunks of 1024 and 32768 and on both 128-tenant
   layouts at 1024 (``split``, and ``global`` forced, timed in turns with
   their bound), and
   ``packed_layer`` on each block-diagonal layer of the 8- and 32-tenant
   merges on the route it takes (``tiled``, held with ``cached``, forced,
   and on the ``concat`` layout timed in turns with it and its bound; the
   8-tenant ``concat`` layers on ``general``, timed in turns with ``tiled``,
   forced, and their bound, as are the (8, 12, 6) tenant's 12 -> 6 layer at
   chunk 1024 and, in step 3, FIVE_TUPLE's 2-neuron output layer);
9. the LM slice, on phi3-mini-3.8b at its published widths (weights from a
   fixed seed):
   a. holds ``bnn_matmul_packed`` (bit for bit, at the decode (M = 4,
      stream), prefill (M = 17 and 128, mma) and scoring (M = 2048, mma)
      shapes of the model's five projections, and on mma and tiled, forced,
      at ragged M, N, Kw and k_bits, a misaligned view, all-ones and all-zero
      words; one decode layer's seven launches also timed as a replayed
      CUDA graph, in turns with the tiled route and with ``torch.matmul`` of
      pre-signed bf16 operands, the three routes at M of 1 to 16, and a
      prefill (M = 128) and a scoring (M = 2048) layer in turns: mma, tiled
      forced, ``torch.matmul`` bf16 and ``torch._int_mm`` int8, with bounds),
      ``bnn_matmul_mxu`` (bit for bit, on its tma route at the model's shape
      and a ragged one, and on its staged route, each sign site also on
      planted subnormal signs) and ``flash_attention``
      (in bf16 on its tma and wmma routes within bf16 rounding's
      element-wise bound and an RMS limit, hubert-xlarge's full attention
      at D = 80, zamba2-1.2b's D = 64 and internvl2-2b's D = 128 among
      them, 1e-5 in float32; hubert's layer timed too) against their
      plain versions,
      each case asserting the route its launch took; each kernel is timed
      beside its plain version and, in turns (kernel, library, library,
      kernel), beside the one PyTorch call that computes the same function,
      where there is one;
      ``chunked_attention`` (``check_chunked``: phi3's prefill at S = 2048
      and 32,768, bf16 scores, qwen3-moe's GQA at 2048 and 32,768,
      deepseek-v2's and minicpm3's MLA, a full ragged case, each bf16 case
      on the tma route and on the first design's mma route, forced; float32) and
      ``decode_attention`` (``check_decode``: phi3's incremental mode over a
      32,768-position cache at index 0, 128 and 32,767, float32, qwen3-moe
      and chatglm3 in the in-cache mode at index 0 and 2047, qwen3-moe over
      32,768 keys) against their plain versions, bf16 within one bf16 ulp
      of |out| + the softmax-weighted mean |v|, float32 within 1e-5 of the
      same; timed beside their plain versions, the forced mma route and
      ``scaled_dot_product_attention`` (a yardstick with other roundings);
   b. drives the public binary-GEMM op ``ops.binary_matmul`` through both
      kernel implementations at a prefill-sized activation;
   c. serves 8 requests through the ``Engine`` (all 32 layers, bf16, packed
      XNOR-popcount projections) and checks that every packed projection
      went through ``bitpack`` (bf16 input, vec route) and
      ``bnn_matmul_packed``, every decode-step launch on its stream route,
      and that every prefill launched one ``chunked_attention`` a layer
      (causal, tma) and every decode step one ``decode_attention`` a layer
      in the model's mode (``attention_launches``; every served model
      below the same way: none in MLA decode or an SSM, the hybrid's
      shared block once a group);
   d. scores one 2048-token sequence with ``forward`` under
      ``attn_impl="pallas_flash"`` (one ``flash_attention`` launch per
      layer, every one on the tma route), and holds a 2-layer float32
      copy's flash logits against its plain-attention logits;
10. the MoE and MLA models (the phi3 parameters freed first; weights from a
   fixed seed, bf16, ``bnn_packed`` on ``ffn``, ``attn_proj`` and ``moe``):
   a. holds ``bnn_matmul_packed_experts`` bit for bit against its plain
      version at qwen3-moe-30b-a3b's and deepseek-v2-236b's gate and down
      shapes at capacities of 1, 10 and 160 slots, at ragged K and odd E,
      each case asserting its route (the mma ones held on tiled, forced,
      too); times one qwen3 decode layer's three launches as a replayed CUDA
      graph over 4 layers' weights, in turns with the tiled route and with
      ``torch.bmm`` of pre-signed bf16 operands, beside the plain version,
      and one scoring layer (C = 160) in turns: mma, tiled forced,
      ``torch.bmm`` bf16 and ``torch._int_mm`` int8, with its bound;
   b. qwen3-moe-30b-a3b at its published config (48 layers, 128 experts
      top-8): the ``Engine`` serves 8 requests as in 9c, each prefill and
      decode step making per layer 4 ``bnn_matmul_packed``, 3
      ``bnn_matmul_packed_experts`` and 7 bf16 ``bitpack`` launches (every
      decode-step launch on the stream route), then ``forward`` scores 2048
      tokens with flash (D = 128, tma; every expert launch on mma);
   c. deepseek-v2-236b at published widths and depth (60 layers, MLA, 160
      experts top-6 and 2 shared): the ``Engine`` serves 4 requests, per
      layer 3 ``bnn_matmul_packed`` (the shared experts; MLA projections
      are never packed), 3 expert launches and 6 ``bitpack``;
   d. minicpm3-4b, stablelm-3b and chatglm3-6b at published widths and 4
      layers: the ``Engine`` serves 4 requests each, launches counted;
      stablelm's ``forward`` with flash at D = 80 takes the tma route;
   e. ``repro_torch.launch.serve.main`` at ``--reduced`` on the card for
      each of the reference's ten architectures: eight serve, and
      hubert-xlarge (encoder-only) and internvl2-2b (the ``Engine`` prefills
      no patches) fail as the reference's launcher does;
11. the SSM, hybrid, VLM and audio models at their published configs
   (each freed before the next; weights from a fixed seed, bf16,
   ``bnn_packed`` on ``ffn``, ``attn_proj`` and ``moe``), each first held on
   a 2-layer float32 unquantized copy at published widths against the
   port's plain path on the CPU (``check_against_cpu``; flash's f32 route
   on the card), and its packed projections' kernels held bit for bit
   against their plain versions at its own shapes (``check_packed_shapes``:
   bf16 ``bitpack`` on the vec route and ``bnn_matmul_packed`` at a decode
   step's M = 4 on the stream route, a prompt's M = 384 and scoring's
   M = 2048 on the mma route, for each (K, N) of zamba2's shared block,
   internvl2 and hubert):
   a. mamba2-1.3b (48 layers, d_model 2048, state 128, 64 SSM heads): the
      ``Engine`` serves 8 requests as in 9c and ``forward`` scores 2048
      tokens; no kernel launches at all (Mamba2 projections are never
      packed and it has no attention);
   b. zamba2-1.2b (38 layers: 6 groups of 6 with the shared attention +
      SwiGLU block after each, a 2-layer tail): serves and scores the same
      way; every packed launch comes from the shared block, 7
      ``bnn_matmul_packed`` and 7 bf16 ``bitpack`` an application, 6
      applications a call (``attention_blocks``); flash at D = 64 (tma);
   c. internvl2-2b (24 layers, 256 patches, vocab 92,553, no decode
      carry): 4 prompts of 256 seeded patch embeddings and 16 to 128
      tokens prefilled into one cache and 32 decode steps by hand
      (``drive_vlm_decode``: the ``Engine`` cannot serve a VLM), then
      ``forward`` scores 256 patches + 1792 tokens with flash at D = 128;
   d. hubert-xlarge (48 layers, d_model 1280, head dim 80, encoder-only):
      ``forward`` over 2048 seeded frames, one full (non-causal)
      ``flash_attention`` launch a layer on the tma route and 6 packed
      launches a layer (GELU FFN 2, attention 4);
   every run's launches exact (``call_launches``, ``attention_launches``),
   every decode-step GEMM on the stream route, every scoring GEMM on mma;
12. trains the LMs (``drive_training``; every run launches no kernel: the
   training forward is the plain path, as the reference's reaches no
   Pallas kernel):
   a. phi3-mini-3.8b at published widths and all 32 layers, bf16,
      ``bnn_weight_only`` on ``ffn`` and ``attn_proj`` (latent weights,
      STE), remat on, ``AdamW(lr=1e-3)`` with its float32 master, stepping
      in place (``AdamW.update_``): ``make_train_step`` (microbatches 1) on
      ``SyntheticTokens(seed=0)`` batches of 8 x 128, one warm-up and 4
      timed steps; prints each step's loss and grad norm, s/step, tokens/s,
      resident and peak GB; loss and grad norm finite, grad norm > 0, every
      master leaf and the bf16 parameters moved;
   b. a 2-layer float32 copy of that step held against the CPU
      (``check_training_against_cpu``: loss, grad norm and every updated
      parameter within 2e-3);
   c. ``repro_torch.launch.train.main`` at ``--reduced`` on the card: phi3
      for 30 steps with microbatches 2, ``--compression sign`` and a failure
      injected at step 15 (one recovery, final step 30, the loss falls),
      then qwen3-moe-30b-a3b (the MoE aux loss) and minicpm3-4b (MLA) for 4
      steps each, losses finite;
13. the one-card dry run (``drive_dryrun``):
   ``repro_torch.launch.dryrun.run_cell`` on the card, each cell at the
   batch its batch-1 measurement gives it (``dryrun.choose_batch``; one
   warm-up, timed steps, one counted step under ``roofline.ops``):
   phi3-mini-3.8b decode_32k (all 32 layers) and prefill_32k (4 layers)
   with ``bnn_packed`` on ``ffn`` and ``attn_proj`` (the hillclimb's C1
   and C2: every packed GEMM of the decode cell on the stream route, of
   the prefill cell on mma), zamba2-1.2b long_500k uncut (a 524,288-position
   KV cache) and hubert-xlarge train_4k at 4 layers (``frames``, the
   encoder-only path, no kernel);
   prints each cell's batch against its global batch, step s, the peak
   against resident + estimate, tokens/s, the roofline bound, bottleneck,
   floor and mfu, and the counted step's kernel launches, kernel bytes and
   top ops by bytes; each cell ok, its output finite, its roofline fraction
   and mfu in (0, 1], the counted step's launches those the count saw, the
   decode cells launching ``decode_attention`` and the prefill cell
   ``chunked_attention`` (the training cell neither);
   then ``bitpack`` and ``bnn_matmul_packed`` at the prefill cell's own M
   (its batch x 32768 rows) for each of phi3's (K, N), the GEMM on the
   mma route, every row held against the plain versions and timed beside
   its bound (``check_prefill_shapes``);
14. prints one JSON line of per-kernel numbers, then the status line.  The
   packet kernels' ``launches`` sum their ``launches_by_path`` (the fleet
   phase's runs under ``fleet``), and ``launches_by_route`` splits the same
   launches by route; the LM kernels' ``launches`` are phi3's (the expert
   GEMM's qwen3's) serving or scoring run's, their ``launches_by_path``
   every LM run's (the bit-pack kernel's LM launches, through its
   ``bitpack`` wrapper, in ``bitpack_launches_by_path``); the attention
   kernels' ``launches`` are phi3's serving run's, their ``ms`` the
   dry-run cells' shapes (prefill of 32,768 tokens, decode over 32,768
   keys), with other shapes' times under ``*_s2048``, ``*_index128`` and
   ``*_chatglm3_2048``.  The packed
   GEMMs' ``ms`` and ``library_ms`` are the decode layer's (stream, and
   ``torch.matmul`` or ``torch.bmm``); every other time names its route or
   yardstick (``*_ms_mma``, ``*_ms_tiled_forced``, ``*_library_ms_torch_*``,
   ``*_ms_torch_int_mm``).  Every bound is
   ``repro_torch.roofline``'s: the kernels' bytes and operations
   (``roofline.kernels``) over the H100 peaks (``roofline.hw``).

Every path is driven with all launch counts zeroed just before it and read
just after.  Serving and scoring run under ``torch.inference_mode()``.  Any failure raises, so the script exits non-zero; it also exits
non-zero without a CUDA device, before doing anything.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.n2net_paper import FIVE_TUPLE, HEADLINE  # noqa: E402
from repro_torch.core import bitops, bnn, compiler, interpreter  # noqa: E402
from repro_torch.core.export import verify_roundtrip  # noqa: E402
from repro_torch.core.pipeline import MAX_FIELDS, RMT, RMT_NATIVE_POPCNT, ChipSpec  # noqa: E402
from repro_torch.dataplane import executor, lowering, pcap, traffic  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.dataplane import fleet  # noqa: E402
from repro_torch.dataplane.factory import Fleet, FleetSpec, TenantSpec, build_fleet  # noqa: E402
from repro_torch.dataplane.plan import ExecutionPlan  # noqa: E402
from repro_torch.dataplane.plan import run as plan_run  # noqa: E402
from repro_torch.dataplane.multitenant import SwitchScheduler  # noqa: E402
from repro_torch.dataplane.fabric import MODES, SwitchFabric  # noqa: E402
from repro_torch.kernels import _build, bitpack, optable_exec, packed_layer  # noqa: E402
from repro_torch.obs.slo import SloSpec  # noqa: E402
from repro_torch.roofline import dataplane as roofline  # noqa: E402
from repro_torch.roofline import kernels as costs  # noqa: E402
from repro_torch.serving.engine import FleetEngine  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs.base import QuantConfig, get_config  # noqa: E402
from repro_torch.kernels import bnn_matmul, bnn_matmul_mxu, flash_attention, ref  # noqa: E402
from repro_torch.kernels import chunked_attention as chunked_kernel  # noqa: E402
from repro_torch.kernels import decode_attention as decode_kernel  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.configs.archs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.layers.moe import capacity_of  # noqa: E402
from repro_torch.models.model import cache_tensors, set_index  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.train.bnn_trainer import BnnTrainConfig, BnnTrainer  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.launch import dryrun, shapes as dryrun_shapes  # noqa: E402

PACKETS = 1 << 20
CHUNK = 1 << 15
# Chunks of a packet-path kernel's launches in one timed CUDA graph: a chunk
# takes microseconds on the device, less than the host needs to replay a
# graph, so a graph of one chunk would time the host.
CHUNK_REPS = 16
SEED = 0
SCENARIO = "ddos_burst"

# Fleets: benchmarks/fleet_bench.py's workload (:40-140): per-stream chunks
# of 16 packets (FLEET_BENCH_CHUNK), 20 blocks, fleets of 4 to 10,240
# streams (FLEET_BENCH_STREAMS and _fleet_sizes), the gate fleet of 64.
FLEET_CHUNK = 16
FLEET_BLOCKS = 20
FLEET_STREAMS = (4, 16, 64, 256, 1024, 4096, 10240)
FLEET_GATE = 64
FLEET_OPTABLE = (FLEET_GATE, FLEET_STREAMS[-1])  # fleets also timed on the op-table backend

FABRIC_HOPS = 4        # FIVE_TUPLE's 122 elements on the 32-element RMT chip
TRAIN_HOPS = 5         # the trainer's default model: 159 elements
TRAIN_MIN_ACCURACY = 0.90  # the gate of examples/train_deploy_loop.py

# Multi-tenant scheduling: benchmarks/multitenant_bench.py's tenant pool
# (:44-47) and operating point (chunk and quantum 1024, :75-79).
MT_PACKETS = 1 << 20
MT_CHUNK = 1 << 10
MT_SHAPES = ((32, 64, 32), (16, 32, 8), (32, 16), (8, 12, 6), (16, 8, 4), (32, 32, 4))
MT_SCENARIOS = ("ddos_burst", "iot_telemetry", "flow_tuple", "adversarial_bitflip", "uniform_random")
MT_WEIGHTS = (3.0, 2.0, 1.0, 1.0, 2.0, 1.0)
MT_WIDE = 128        # tenants of the widest interleaved packed run
MT_OVER = 32         # tenants whose merged register file is past the shared route
MT_OVER_REGS = 1833
# examples/pcap_replay.py section 5: a 20,000-packet capture as one tenant of
# three, twice its length served in chunks of 4096.
PCAP_PACKETS = 20_000
PCAP_CHUNK = 4096
PCAP_SCENARIO = "pcap:chip_smoke"

LM_ARCH = "phi3-mini-3.8b"
LM_REQUESTS = 8
LM_NEW_TOKENS = 32
LM_SCORE_LEN = 2048


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, *args, iters: int = 20) -> float:
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def same(what: str, out: torch.Tensor, ref: torch.Tensor) -> int:
    """Fail unless ``out`` equals ``ref`` bit for bit; returns the max
    absolute difference measured (0 when it returns)."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{what}: kernel gives {out.dtype} {tuple(out.shape)}, "
                             f"plain {ref.dtype} {tuple(ref.shape)}")
    diff = int((out.long() - ref.long()).abs().max().item()) if out.numel() else 0
    if diff or not torch.equal(out, ref):
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max diff {diff})")
    print(f"  {what}: bit-exact")
    return diff


def build_kernels() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for {len(logs)} sources (nvcc in parallel)")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(key in line for key in ("Compiling entry", "registers", "spill", "warning")):
                print(f"  {name}: {line.strip()}")


def optable_bound(lowered, plan, batch: int) -> tuple[float, str]:
    """The bound of one program over ``batch`` packets, whatever the route
    (``roofline.kernels.optable_run``)."""
    return costs.optable_run(lowered.num_regs, batch, lowered.num_ops, plan.records.nbytes).bound_ms()


def check_optable(dev, programs: dict) -> dict:
    """``optable_run`` against its plain version on each program's parsed
    chunk, on the route it takes (``shared``: every one fits) and on the
    ``split`` and ``global`` routes, forced, each timed; HEADLINE and
    FIVE_TUPLE time the three routes in turns.  The record holds the headline model's (the main
    path's) numbers.  The tables come from the executor's cache, as on the
    main path, so their plan was made from the host's copy."""
    run = optable_exec.optable_run
    err, times = 0, {}
    for label, (lowered, packets) in programs.items():
        t = executor._device_tables(lowered, dev)
        regs = executor.parse_packets(packets, *t.io[:2], num_regs=lowered.num_regs)
        tables = (*t.ops, t.first_write)
        plan, records = optable_exec.prepare(tables, lowered.num_regs)
        plans = {"shared": (plan, records), "split": optable_exec.prepare_split(tables, lowered.num_regs),
                 "global": (plan, records)}
        threads = optable_exec.plan_threads(plan, lowered.num_regs)
        want = optable_exec.optable_run_plain(regs, *tables)
        err = max(err, same(
            f"optable_run {label} ({lowered.num_regs} regs x {CHUNK} packets, {int(plan.rows.sum())} "
            f"true rows of {lowered.opcode.size}, {int(plan.deferred.sum())} deferred, scratch "
            f"{plan.max_deferred}, {threads} threads/block, shared)",
            routed(run, "shared", lambda: run(regs, *tables)), want))
        for path in ("split", "global"):
            err = max(err, same(f"optable_run {label} ({path}, forced)",
                                routed(run, path, lambda: optable_exec._launch(regs, *plans[path], path)),
                                want))
        if label == "HEADLINE/rmt+popcnt32":
            times[label] = time_ms(run, regs, *tables)
            print(f"    optable_run {label}: {times[label]} ms per chunk of {CHUNK}")
            continue
        t_route = in_turns({path: (lambda path=path: optable_exec._launch(regs, *plans[path], path))
                            for path in optable_exec.ROUTES})
        times[label] = t_route["shared"]
        times[f"{label} global"] = t_route["global"]
        times[f"{label} split"] = t_route["split"]
        print(f"    optable_run {label}: shared {t_route['shared']} ms, split {t_route['split']} ms, global "
              f"{t_route['global']} ms per chunk of {CHUNK}; bound {optable_bound(lowered, plan, CHUNK)[0]} ms")
        if label == "HEADLINE/rmt":
            plain = time_ms(optable_exec.optable_run_plain, regs, *tables, iters=3)
            b_ms, b_by = optable_bound(lowered, plan, CHUNK)
            # One packet walks every row as a full chunk's packets do.
            one = regs[:, :1].contiguous()
            times["one packet"] = time_ms(lambda: optable_exec._launch(one, plan, records, "shared"))
            print(f"    optable_run {label}, shared, one packet: {times['one packet']} ms")
    return dict(
        source="src/repro_torch/csrc/optable_exec.cu",
        replaces="src/repro/kernels/optable_exec.py:87",
        max_abs_err=err, ms=times["HEADLINE/rmt"], plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        ms_global=times["HEADLINE/rmt global"], ms_split=times["HEADLINE/rmt split"],
        ms_one_packet=times["one packet"], ms_five_tuple=times["FIVE_TUPLE/rmt"],
        ms_five_tuple_global=times["FIVE_TUPLE/rmt global"], ms_five_tuple_split=times["FIVE_TUPLE/rmt split"],
    )


# Subnormals of both signs, the boundary -FLT_MIN (a normal number), ±0.0, NaN
# and ±inf.  The reference computes its signs with subnormals flushed to zero,
# so a negative subnormal has sign bit 1 (core/bitops.py::sign_bit).
FLT_MIN = 2.0 ** -126
PLANTED = [-1e-40, 1e-40, -1e-45, -FLT_MIN / 2, -FLT_MIN, -0.0, 0.0, float("nan"),
           float("-inf"), float("inf")]
PLANTED_BITS = [1, 1, 1, 1, 0, 1, 1, 0, 0, 1]


def planted(shape, dtype, gen, dev) -> torch.Tensor:
    """Normal data with PLANTED in row 0 from column 3 and -1e-39 in every
    third column of the last row."""
    x = torch.randn(shape, generator=gen)
    x[0, 3:3 + len(PLANTED)] = torch.tensor(PLANTED)
    x[-1, ::3] = -1e-39
    return x.to(dev, dtype)


def shifted(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts ``nbytes`` past a 16-byte
    boundary (a misaligned view)."""
    itemsize = t.element_size()
    buf = torch.zeros(t.numel() + 32 // itemsize, dtype=t.dtype, device=t.device)
    skip = ((16 - buf.data_ptr() % 16) % 16 + nbytes) // itemsize
    out = buf[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def check_bitpack(dev, layer_inputs) -> dict:
    """``pack_bits_words`` and ``bitpack`` against the plain packer on both
    routes: ragged widths (scalar), whole 16-byte vectors (vec), misaligned
    views (scalar), float32 and bf16 with planted subnormal signs, bf16 at
    the LM's decode (M = 4) and scoring (M = 2048) shapes, and the main
    path's per-layer inputs.

    Timed per chunk (the main path's two launches) as the device time of a
    replayed CUDA graph of CHUNK_REPS chunks, the vec route in turns with the
    scalar route (the first design: a warp per word) and with one packet,
    and back to back with events (the wrapper's host time included).  bf16
    ``bitpack`` is timed the same way at one decode layer's seven launches (in turns with
    the float32 cast and launch it replaced) and at the scoring shapes."""
    pbw, bp = bitpack.pack_bits_words, bitpack.bitpack
    err = 0
    gen = torch.Generator().manual_seed(SEED)
    for n in (1, 31, 33, 100, 2048):
        bits = torch.randint(0, 2, (4099, n), generator=gen, dtype=torch.int32).to(dev)
        path = "vec" if n % 4 == 0 else "scalar"
        err = max(err, same(f"pack_bits_words (4099, {n}) ({path})", routed(pbw, path, lambda: pbw(bits)),
                            bitpack.pack_ge_plain(bits, 1)))
        err = max(err, same(f"pack_bits_words (4099, {n}) misaligned by 4 bytes (scalar)",
                            routed(pbw, "scalar", lambda: pbw(shifted(bits, 4))),
                            bitpack.pack_ge_plain(bits, 1)))
    for dtype in (torch.float32, torch.bfloat16):
        x = planted((4099, 256), dtype, gen, dev)
        want = bitpack.pack_ge_plain(x, 0)
        head = bitops.unpack_bits(bitops.i32_to_u32(want[:1].cpu()))[0, 3:3 + len(PLANTED)]
        if head.tolist() != PLANTED_BITS:
            raise AssertionError(f"plain sign bits of the planted values: {head.tolist()}")
        for path, xv in (("vec", x), ("scalar", shifted(x, 8))):
            err = max(err, same(f"bitpack {dtype} (4099, 256) with subnormal signs ({path})",
                                routed(bp, path, lambda: bp(xv)), want))
    for m, k in ((DECODE_M, 3072), (DECODE_M, 8192), (2048, 3072), (2048, 8192)):
        x = planted((m, k), torch.bfloat16, gen, dev)
        err = max(err, same(f"bitpack bf16 ({m}, {k}) (vec)", routed(bp, "vec", lambda: bp(x)),
                            bitpack.pack_ge_plain(x, 0)))
    plain = 0.0
    for h in layer_inputs:
        err = max(err, same(f"pack_bits_words {tuple(h.shape)} (vec)", routed(pbw, "vec", lambda: pbw(h)),
                            bitpack.pack_ge_plain(h, 1)))
        plain += time_ms(bitpack.pack_ge_plain, h, 1, iters=5)
    b_ms, b_by = costs.total(costs.bitpack(*h.shape) for h in layer_inputs).bound_ms()
    back_to_back = sum(time_ms(pbw, h) for h in layer_inputs)

    def chunk(path, rows=CHUNK):
        hs = [h[:rows] for h in layer_inputs]
        outs = [torch.empty((rows, bitpack.num_words(h.shape[1])), dtype=torch.int32, device=dev) for h in hs]
        return lambda: [bitpack._launch(h, out, 1, path, pbw) for h, out in zip(hs, outs)]

    # CHUNK_REPS chunks a graph; the same launches on one packet give their
    # fixed cost in a graph.
    per_chunk = graphs_in_turns({name: repeated(call, CHUNK_REPS) for name, call in (
        ("vec", chunk("vec")), ("scalar", chunk("scalar")), ("vec, 1 packet", chunk("vec", 1)))})
    per_chunk = {name: v / CHUNK_REPS for name, v in per_chunk.items()}
    print(f"  pack_bits_words per chunk of {CHUNK} (2 launches): graph replay vec {per_chunk['vec']} ms, "
          f"scalar {per_chunk['scalar']} ms (one packet: {per_chunk['vec, 1 packet']} ms); back to back "
          f"(events) {back_to_back} ms; bound {b_ms} ms ({b_by})")

    # bf16 bitpack: one decode layer's seven activations (K = 3072 six
    # times, 8192 once) over GRAPH_LAYERS layers, and the scoring shapes.
    ks = [3072] * 6 + [8192]
    xs = [[torch.randn((DECODE_M, k), generator=gen).to(dev, torch.bfloat16) for k in ks]
          for _ in range(GRAPH_LAYERS)]
    outs = [[torch.empty((DECODE_M, k // 32), dtype=torch.int32, device=dev) for k in ks]
            for _ in range(GRAPH_LAYERS)]
    flat = [(x, o) for lx, lo in zip(xs, outs) for x, o in zip(lx, lo)]
    t = graphs_in_turns({
        "bf16 vec": lambda: [bitpack._launch(x, o, 0, "vec", bp) for x, o in flat],
        "bf16 scalar": lambda: [bitpack._launch(x, o, 0, "scalar", bp) for x, o in flat],
        "cast + float32 vec": lambda: [bitpack._launch(x.float(), o, 0, "vec", bp) for x, o in flat],
    })
    print(f"  bitpack bf16 per decode layer (7 launches, M={DECODE_M}), graph replay: "
          + ", ".join(f"{name} {v / GRAPH_LAYERS} ms" for name, v in t.items())
          + f"; bound {costs.total(costs.bitpack(DECODE_M, k, 2) for k in ks).bound_ms()[0]} ms")
    # Scoring shapes: distinct inputs, 100 MB or more a graph (twice the L2),
    # so each launch reads from device memory.
    for k in (3072, 8192):
        copies = -(-100_000_000 // (2048 * k * 2))
        xs = [torch.randn((2048, k), generator=gen).to(dev, torch.bfloat16) for _ in range(copies)]
        outs = [torch.empty((2048, k // 32), dtype=torch.int32, device=dev) for _ in range(copies)]
        t = graphs_in_turns({path: (lambda path=path: [bitpack._launch(x, o, 0, path, bp)
                                                       for x, o in zip(xs, outs)])
                             for path in ("vec", "scalar")})
        t = {path: v / copies for path, v in t.items()}
        sb_ms, sb_by = costs.bitpack(2048, k, 2).bound_ms()
        print(f"  bitpack bf16 (2048, {k}), graph replay over {copies} inputs, per launch: vec {t['vec']} ms "
              f"({t['vec'] / sb_ms} x bound), scalar {t['scalar']} ms; bound {sb_ms} ms ({sb_by})")
        del xs, outs
    return dict(
        source="src/repro_torch/csrc/bitpack.cu",
        replaces="src/repro/kernels/bitpack.py:35",
        max_abs_err=err, ms=per_chunk["vec"], old_route_ms=per_chunk["scalar"],
        back_to_back_ms=back_to_back, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
    )


def time_general_layer(label: str, args, rec: dict) -> int:
    """``packed_layer`` on a layer the wrapper sends to the ``general`` route
    (the first design: a thread per output), on it and on ``tiled``, forced,
    both held against the plain version and timed in turns as replayed
    graphs of CHUNK_REPS launches, beside the bound.  Records
    ``ms_general_<label>``, ``ms_tiled_forced_<label>`` and
    ``bound_ms_<label>`` in ``rec``; returns the max error."""
    fn = packed_layer.packed_layer
    (batch, n_words), n_out = args[0].shape, args[1].shape[0]
    if packed_layer.route(*args[:2]) != "general":
        raise AssertionError(f"{label}: routes to {packed_layer.route(*args[:2])}, not general")
    want = packed_layer.packed_layer_plain(*args)
    out = torch.empty_like(want)
    err = max(same(f"packed_layer {label} ({n_out} x {n_words} words, {batch} packets, general)",
                   routed(fn, "general", lambda: fn(*args)), want),
              same(f"packed_layer {label} (tiled, forced)",
                   routed(fn, "tiled", lambda: packed_layer._launch(*args, out, "tiled")), want))
    t = graphs_in_turns({name: repeated(lambda name=name: packed_layer._launch(*args, out, name), CHUNK_REPS)
                         for name in ("general", "tiled")})
    b_ms, b_by = costs.packed_layer(batch, n_words, n_out).bound_ms()
    rec[f"ms_general_{label}"] = t["general"] / CHUNK_REPS
    rec[f"ms_tiled_forced_{label}"] = t["tiled"] / CHUNK_REPS
    rec[f"bound_ms_{label}"] = b_ms
    print(f"    packed_layer {label} ({n_out} x {n_words} words, {batch} packets): general "
          f"{t['general'] / CHUNK_REPS} ms, tiled (forced) {t['tiled'] / CHUNK_REPS} ms a launch; bound {b_ms} ms "
          f"({b_by})")
    return err


def check_packed_layer(dev, lp, layer_inputs, five) -> dict:
    """``packed_layer`` against its plain version on the main path's layers
    (quad route), the scan plan's padded layers (pad neurons must never
    fire), FIVE_TUPLE's layers (4, 2 and 1 words; its 2-neuron output layer
    takes the general route; each also on the tiled route, forced) and its
    scan plan, and every main-path layer on the general, tiled and cached
    routes, forced.

    Timed per chunk (the main path's two launches) as the device time of a
    replayed CUDA graph of CHUNK_REPS chunks, the quad route in turns with the
    general route (the first design: a thread per output), the tiled and
    cached routes (the two designs for tables past shared memory) and with
    one packet, and back to back with events; FIVE_TUPLE's layers on their
    routes in turns with the tiled route."""
    fn = packed_layer.packed_layer

    def operands(weights, mask, thresholds, h):
        return (bitpack.pack_bits_words(h), executor._i32(weights).to(dev),
                executor._i32(mask).to(dev), executor._i32(thresholds).to(dev))

    err = 0
    plain = back_to_back = 0.0
    chunk_args, layer_costs = [], []
    for pl, h in zip(lp.packed.layers, layer_inputs):
        args = operands(pl.weights, pl.mask, pl.thresholds, h)
        want = packed_layer.packed_layer_plain(*args)
        for path in packed_layer.ROUTES:
            out = torch.empty_like(want)
            err = max(err, same(f"packed_layer {pl.n_in}->{pl.n_out} ({CHUNK} packets, {path})",
                                routed(fn, path, lambda: packed_layer._launch(*args, out, path)), want))
        routed(fn, "quad", lambda: fn(*args))
        back_to_back += time_ms(fn, *args)
        plain += time_ms(packed_layer.packed_layer_plain, *args, iters=5)
        layer_costs.append(costs.packed_layer(*args[0].shape, pl.n_out))
        chunk_args.append((args, torch.empty_like(want)))
    b_ms, b_by = costs.total(layer_costs).bound_ms()

    def stacked(lowered, h, label):
        nonlocal err
        sp = lowering.stack_packed_layers(lowered.packed)
        h = torch.nn.functional.pad(h, (0, sp.max_bits - h.shape[1]))
        for li, pl in enumerate(lowered.packed.layers):
            args = (bitpack.pack_bits_words(h)[:, :sp.max_words].contiguous(),
                    executor._i32(sp.weights[li]).to(dev), executor._i32(sp.mask[li]).to(dev),
                    executor._i32(sp.thresholds[li]).to(dev))
            out = routed(fn, packed_layer.route(*args[:2]), lambda: fn(*args))
            err = max(err, same(f"packed_layer {label} stacked layer {li} with {sp.max_out - pl.n_out} "
                                f"pad neurons ({packed_layer.route(*args[:2])})",
                                out, packed_layer.packed_layer_plain(*args)))
            if out[:, pl.n_out:].any():
                raise AssertionError(f"{label}: a pad neuron (threshold 0xFFFFFFFF) fired")
            h = torch.nn.functional.pad(out, (0, sp.max_bits - out.shape[1]))

    stacked(lp, layer_inputs[0], "HEADLINE")
    five_lp, five_packets = five
    h = five_packets
    five_layers = []  # (operands, an output buffer, the layer's route)
    for pl in five_lp.packed.layers:
        args = operands(pl.weights, pl.mask, pl.thresholds, h)
        path = packed_layer.route(*args[:2])
        want = "quad" if pl.n_out % 4 == 0 else "general"
        if path != want:
            raise AssertionError(f"FIVE_TUPLE layer {pl.n_in}->{pl.n_out} routes to {path}, not {want}")
        h = routed(fn, path, lambda: fn(*args))
        plain_out = packed_layer.packed_layer_plain(*args)
        err = max(err, same(f"packed_layer FIVE_TUPLE {pl.n_in}->{pl.n_out} ({pl.n_words} words, {path})",
                            h, plain_out))
        out = torch.empty_like(h)
        err = max(err, same(f"packed_layer FIVE_TUPLE {pl.n_in}->{pl.n_out} (tiled, forced)",
                            routed(fn, "tiled", lambda: packed_layer._launch(*args, out, "tiled")), plain_out))
        five_layers.append((args, out, path))
    stacked(five_lp, five_packets, "FIVE_TUPLE")
    general = {}  # FIVE_TUPLE's output layer, where general serves
    for args, out, path in five_layers:
        if path == "general":
            pl_out, pl_words = args[1].shape
            err = max(err, time_general_layer(f"five_tuple_{pl_words}_words_to_{pl_out}_chunk_{CHUNK}", args,
                                              general))
    # FIVE_TUPLE's layers per chunk on their routes and on tiled, forced.
    t5 = graphs_in_turns({name: repeated(lambda name=name: [
        packed_layer._launch(*args, out, path if name == "routes" else "tiled") for args, out, path in five_layers],
        CHUNK_REPS) for name in ("routes", "tiled")})
    t5 = {name: v / CHUNK_REPS for name, v in t5.items()}
    print(f"  packed_layer FIVE_TUPLE per chunk of {CHUNK} ({len(five_layers)} launches): graph replay on their "
          f"routes {t5['routes']} ms, tiled {t5['tiled']} ms")

    def chunk(path, rows=CHUNK):
        cut = [((args[0][:rows], *args[1:]), out[:rows]) for args, out in chunk_args]
        return lambda: [packed_layer._launch(*args, out, path) for args, out in cut]

    # CHUNK_REPS chunks a graph; the same launches on one packet give their
    # fixed cost in a graph.
    t = graphs_in_turns({name: repeated(call, CHUNK_REPS) for name, call in (
        ("quad", chunk("quad")), ("general", chunk("general")), ("tiled", chunk("tiled")),
        ("cached", chunk("cached")),
        ("quad, 1 packet", chunk("quad", 1)))})
    t = {name: v / CHUNK_REPS for name, v in t.items()}
    print(f"  packed_layer per chunk of {CHUNK} (2 launches): graph replay quad {t['quad']} ms, "
          f"general {t['general']} ms, tiled {t['tiled']} ms, cached {t['cached']} ms (one packet: "
          f"{t['quad, 1 packet']} ms); "
          f"back to back (events) {back_to_back} ms; bound {b_ms} ms ({b_by})")
    return dict(
        source="src/repro_torch/csrc/packed_layer.cu",
        replaces="src/repro/dataplane/executor.py:213",
        max_abs_err=err, ms=t["quad"], old_route_ms=t["general"], tiled_route_ms=t["tiled"],
        cached_route_ms=t["cached"], five_tuple_ms=t5["routes"], five_tuple_tiled_ms=t5["tiled"],
        back_to_back_ms=back_to_back,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, **general,
    )


def drive_main_path(dev, lp, records: dict) -> dict:
    """Stream the packets through each backend with every launch count
    zeroed just before and read just after; returns the stream results."""
    counters = {
        "optable_run": optable_exec.optable_run,
        "pack_bits_words": bitpack.pack_bits_words,
        "packed_layer": packed_layer.packed_layer,
    }
    path_kernels = {"jnp": ("optable_run",), "packed": ("pack_bits_words", "packed_layer")}
    # The packed backend's launches on HEADLINE all take the new routes, the
    # op-table backend's the shared route.
    path_routes = {"pack_bits_words": "vec", "packed_layer": "quad", "optable_run": "shared"}
    results = {}
    for backend, label in (("jnp", "op-table"), ("packed", "packed")):
        zero_counts()
        sr = executor.execute_stream(
            lp,
            traffic.stream(SCENARIO, PACKETS, HEADLINE.input_bits, chunk_size=CHUNK, seed=SEED),
            backend=backend, chunk_size=CHUNK, collect=True, device=dev,
        )
        launches = {name: fn.launches for name, fn in counters.items()}
        for name in path_kernels[backend]:
            if launches[name] <= 0:
                raise AssertionError(f"the {label} backend never launched {name}")
            by_route = counters[name].launches_by_route if name in path_routes else {}
            if by_route and by_route[path_routes[name]] != launches[name]:
                raise AssertionError(f"{name} launches by route {by_route}, expected all on "
                                     f"{path_routes[name]}")
        count_path(records, f"packet path, {label}", {n: launches[n] for n in path_kernels[backend]})
        results[backend] = sr
        print(
            f"main path, {label} backend: {sr.packets} packets in {sr.chunks} chunks, "
            f"{sr.seconds:.4f} s -> {sr.packets_per_second:.6e} pkt/s "
            f"(warm-up {sr.warmup_seconds:.2f} s), launches {launches}"
        )
    return results


def count_path(records: dict, path: str, launches: dict) -> None:
    """Add one path's launch counts to the records' ``launches_by_path``
    (a path driven by several runs sums them), and its launches by route
    (read now, right after the path) to their ``launches_by_route``."""
    for name, n in launches.items():
        by_path = records[name].setdefault("launches_by_path", {})
        by_path[path] = by_path.get(path, 0) + n
        by_route = getattr(COUNTED[name], "launches_by_route", None)
        if by_route:
            total = records[name].setdefault("launches_by_route", dict.fromkeys(by_route, 0))
            for route, k in by_route.items():
                total[route] += k


def check_optable_route(label: str, launches: dict, path: str = "shared") -> None:
    """Fail unless every ``optable_run`` launch of a path took ``path``."""
    n = launches.get("optable_run", 0)
    by_route = optable_exec.optable_run.launches_by_route
    if by_route[path] != n:
        raise AssertionError(f"{label}: optable_run launches by route {by_route}, expected all {n} on {path}")


def check_stacked_planes(dev, prog, lp, first: torch.Tensor, records: dict) -> None:
    """``optable_run`` on each stacked hop plane against its plain version,
    chained over the first chunk's parsed registers with a nonzero null
    register: the last hop's whole pad elements (no true row) must zero it
    as the plain version does.  Not counted as main-path launches."""
    stacked = SwitchFabric.partition(prog).stacked_hops()
    regs = executor.parse_packets(first, *executor._device_tables(lp, dev).io[:2], num_regs=lp.num_regs)
    regs[-1] = 0xBEEF
    err = 0
    for h, tables in enumerate(executor._stacked_tables(stacked, dev)):
        plan, _ = optable_exec.prepare(tables, stacked.num_regs)
        empty = int((plan.rows == 0).sum())
        out = optable_exec.optable_run(regs, *tables)
        err = max(err, same(f"optable_run stacked hop {h} of {stacked.num_hops} ({empty} elements with "
                            f"no true row, nonzero null register)",
                            out, optable_exec.optable_run_plain(regs, *tables)))
        regs = out
    if not empty:
        raise AssertionError("the last stacked hop has no pad element: nothing checked the pads")
    records["optable_run"]["max_abs_err"] = max(records["optable_run"]["max_abs_err"], err)


def drive_fabric(dev, prog, params, records: dict) -> None:
    """FIVE_TUPLE across FABRIC_HOPS switches: both modes, three paths each,
    over all PACKETS packets, each run's launches counted from zero."""
    packets = traffic.generate(SCENARIO, PACKETS, FIVE_TUPLE.input_bits, seed=SEED)
    lp = prog.lower()
    t0 = time.perf_counter()
    want = executor.execute(lp, packets, chunk_size=CHUNK, device=dev)
    print(f"fabric: FIVE_TUPLE {lp.summary()}; executor.execute of the unsliced program on "
          f"{PACKETS} packets: {time.perf_counter() - t0} s")
    first = torch.from_numpy(packets[:CHUNK]).to(dev)
    witness = interpreter.run_program(prog, first, device=dev).cpu().numpy()
    oracle = bnn.forward([p.to(dev) for p in params], first).cpu().numpy()
    if not (np.array_equal(want[:CHUNK], witness) and np.array_equal(witness, oracle)):
        raise AssertionError("fabric: executor disagrees with run_program or the BNN oracle on the first chunk")
    check_stacked_planes(dev, prog, lp, first, records)
    # One switch, no hops: the same program in one launch a chunk, the
    # baseline of what the hop chain costs.
    zero_counts()
    sr = executor.execute_stream(lp, (packets[i:i + CHUNK] for i in range(0, PACKETS, CHUNK)),
                                 chunk_size=CHUNK, collect=True, device=dev)
    launches = read_counts()
    check_optable_route("fabric baseline", launches)
    if not np.array_equal(sr.outputs, want):
        raise AssertionError("fabric: execute_stream of the unsliced program disagrees with execute")
    count_path(records, "fabric baseline, one switch (execute_stream)", launches)
    print(f"fabric baseline, one switch: {sr.packets} packets, {sr.seconds} s -> {sr.packets_per_second} "
          f"pkt/s (warm-up {sr.warmup_seconds} s); launches {launches}")
    runs = -(-PACKETS // CHUNK) + 1  # every chunk and the warm call
    layers = len(lp.packed.layers)
    paths = (("op-table scanned", "jnp", True, {"optable_run": FABRIC_HOPS * runs}),
             ("op-table unrolled", "jnp", False, {"optable_run": FABRIC_HOPS * runs}),
             ("packed", "packed", None, {"pack_bits_words": layers * runs, "packed_layer": layers * runs}))
    for mode in MODES:
        fab = SwitchFabric.partition(prog, mode=mode)
        ranges = [h.element_range for h in fab.hops]
        if fab.num_hops != FABRIC_HOPS:
            raise AssertionError(f"FIVE_TUPLE partitions into {fab.num_hops} hops {ranges}, not {FABRIC_HOPS}")
        for label, backend, scan_hops, expect in paths:
            torch.cuda.synchronize()
            zero_counts()
            res = fab.run(packets, backend=backend, scan_hops=scan_hops, chunk_size=CHUNK, device=dev)
            launches = read_counts()
            if launches != expect:
                raise AssertionError(f"fabric {mode} {label}: launches {launches}, expected {expect}")
            check_optable_route(f"fabric {mode} {label}", launches)
            if not np.array_equal(res.outputs, want):
                bad = int((res.outputs != want).any(axis=1).sum())
                raise AssertionError(f"fabric {mode} {label}: {bad} packets disagree with executor.execute")
            count_path(records, f"fabric {mode}, {label}", launches)
            print(f"fabric {mode}, {label}: {FABRIC_HOPS} hops {ranges}, {res.packets} packets, "
                  f"{res.seconds} s -> {res.packets_per_second} pkt/s (warm-up {res.warmup_seconds} s); "
                  f"hop_seconds {[float(t) for t in res.hop_seconds]} ({'attributed by elements' if res.scanned else 'measured'}); "
                  f"launches {launches}; bit-exact with executor.execute on every packet")
        print(fab.telemetry().render())
    print(f"fabric: all three paths in both modes bit-exact on {PACKETS} packets; first chunk == "
          f"run_program == bnn.forward")


# ---------------------------------------------------------------------------
# Fleets of switches
# ---------------------------------------------------------------------------

def fleet_check_kernels(dev, lp, x: np.ndarray, records: dict) -> None:
    """The three kernels of the fleet's dispatch against their plain versions
    at the batches a fleet gives them (the gate fleet's and the widest
    fleet's block: 64 and 10,240 streams of FLEET_CHUNK packets), on the
    routes they take there, each timed with its bound.  Not counted as
    main-path launches."""
    run, pbw, fn = optable_exec.optable_run, bitpack.pack_bits_words, packed_layer.packed_layer
    t = executor._device_tables(lp, dev)
    tables = (*t.ops, t.first_write)
    plan, _ = optable_exec.prepare(tables, lp.num_regs)
    for streams in (FLEET_GATE, FLEET_STREAMS[-1]):
        n = streams * FLEET_CHUNK
        pkt = torch.from_numpy(np.resize(x, (n, x.shape[1]))).to(dev)
        regs = executor.parse_packets(pkt, *t.io[:2], num_regs=lp.num_regs)
        rec = records["optable_run"]
        rec["max_abs_err"] = max(rec["max_abs_err"], same(
            f"optable_run HEADLINE, fleet block of {streams} x {FLEET_CHUNK} = {n} packets (shared)",
            routed(run, "shared", lambda: run(regs, *tables)), optable_exec.optable_run_plain(regs, *tables)))
        rec[f"ms_fleet_{n}"] = time_ms(run, regs, *tables)
        rec[f"bound_ms_fleet_{n}"] = optable_bound(lp, plan, n)[0]
        h = pkt
        pack_ms = layer_ms = 0.0
        pack_costs, layer_costs = [], []
        for pl in lp.packed.layers:
            words = routed(pbw, "vec", lambda: pbw(h))
            rec = records["pack_bits_words"]
            rec["max_abs_err"] = max(rec["max_abs_err"], same(
                f"pack_bits_words {tuple(h.shape)}, fleet block (vec)", words, bitpack.pack_ge_plain(h, 1)))
            pack_ms += time_ms(pbw, h)
            pack_costs.append(costs.bitpack(*h.shape))
            args = (words, executor._i32(pl.weights).to(dev), executor._i32(pl.mask).to(dev),
                    executor._i32(pl.thresholds).to(dev))
            path = packed_layer.route(*args[:2])
            out = routed(fn, path, lambda: fn(*args))
            rec = records["packed_layer"]
            rec["max_abs_err"] = max(rec["max_abs_err"], same(
                f"packed_layer {pl.n_in}->{pl.n_out}, fleet block of {n} packets ({path})",
                out, packed_layer.packed_layer_plain(*args)))
            layer_ms += time_ms(fn, *args)
            layer_costs.append(costs.packed_layer(n, pl.n_words, pl.n_out))
            h = out
        records["pack_bits_words"][f"ms_fleet_{n}"] = pack_ms
        records["pack_bits_words"][f"bound_ms_fleet_{n}"] = costs.total(pack_costs).bound_ms()[0]
        records["packed_layer"][f"ms_fleet_{n}"] = layer_ms
        records["packed_layer"][f"bound_ms_fleet_{n}"] = costs.total(layer_costs).bound_ms()[0]
        # The block's output bits copied to the host as a fleet run's clock
        # takes them (``.cpu()``, pageable) and into a pinned buffer made
        # once (host clock, 5 copies after a warm one).
        pinned = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
        copy_ms = {}
        for name, copy in (("pageable", lambda: h.cpu().numpy()), ("pinned", lambda: pinned.copy_(h))):
            copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                copy()
            copy_ms[name] = (time.perf_counter() - t0) / 5 * 1e3
        print(f"    fleet block of {n} packets, back to back (events): optable_run "
              f"{records['optable_run'][f'ms_fleet_{n}']} ms (bound {records['optable_run'][f'bound_ms_fleet_{n}']}); "
              f"pack_bits_words {pack_ms} ms (bound {records['pack_bits_words'][f'bound_ms_fleet_{n}']}); "
              f"packed_layer {layer_ms} ms (bound {records['packed_layer'][f'bound_ms_fleet_{n}']}); its "
              f"{tuple(h.shape)} int32 output bits to the host: {copy_ms} ms")


def fleet_launches(lp, backend: str, blocks: int) -> dict:
    """The launches a fleet run's path makes: its blocks and the warm call,
    one ``optable_run`` each on the op-table backend, a ``pack_bits_words``
    and a ``packed_layer`` a layer on the packed backend."""
    runs = blocks + 1
    if backend == "jnp":
        return {"optable_run": runs}
    layers = len(lp.packed.layers)
    return {"pack_bits_words": layers * runs, "packed_layer": layers * runs}


def fleet_run(label: str, lp, backend: str, call, records: dict):
    """``call()`` with every launch count zeroed just before and read just
    after: the launches must be exactly those of the path
    (``fleet_launches``), every ``optable_run`` on ``shared``, every
    ``pack_bits_words`` on ``vec`` and each ``packed_layer`` launch on its
    layer's route.  Counted as the ``fleet`` path.  Returns ``call()``'s
    result and the launches by kernel, each with its launches by route."""
    torch.cuda.synchronize()
    zero_counts()
    res = call()
    launches = read_counts()
    expect = fleet_launches(lp, backend, res.chunks)
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected {expect}")
    check_optable_route(label, launches)
    if bitpack.pack_bits_words.launches_by_route["vec"] != launches.get("pack_bits_words", 0):
        raise AssertionError(f"{label}: pack_bits_words by route {bitpack.pack_bits_words.launches_by_route}")
    layer_by_route = dict(packed_layer.packed_layer.launches_by_route)
    if "packed_layer" in launches and layer_by_route != layer_routes(lp.packed.layers, res.chunks + 1):
        raise AssertionError(f"{label}: packed_layer by route {layer_by_route}")
    count_path(records, "fleet", launches)
    return res, {name: (n, dict(getattr(COUNTED[name], "launches_by_route", {}))) for name, n in launches.items()}


def probe_line(rf, pps: float) -> str:
    """The dispatch's bound and the fraction of it reached; fails unless the
    fraction is in (0, 1]."""
    frac = rf.fraction(pps)
    if not 0 < frac <= 1:
        raise AssertionError(f"roofline {rf.path}: fraction {frac} of {rf.roofline_pps} pkt/s not in (0, 1]")
    return (f"roofline {rf.path} (chunk {rf.chunk} x {rf.streams}): bound {rf.roofline_pps} pkt/s "
            f"({rf.bottleneck}; {rf.bytes_per_packet} bytes a packet), fraction {frac}")


def fleet_wants(dev, prog, lp, params, streams: list) -> np.ndarray:
    """One ``executor.execute`` over every stream's packets; on each stream's
    first block (its first FLEET_CHUNK packets) the interpreter and the BNN
    oracle must agree with it."""
    want = executor.execute(lp, np.concatenate(streams), chunk_size=CHUNK, device=dev)
    starts = np.cumsum([0] + [len(s) for s in streams])
    head = np.concatenate([s[:FLEET_CHUNK] for s in streams])
    rows = np.concatenate([np.arange(a, a + min(FLEET_CHUNK, b - a)) for a, b in zip(starts, starts[1:])])
    dev_head = torch.from_numpy(head).to(dev)
    witness = interpreter.run_program(prog, dev_head, device=dev).cpu().numpy()
    oracle = bnn.forward([p.to(dev) for p in params], dev_head).cpu().numpy()
    if not (np.array_equal(want[rows], witness) and np.array_equal(witness, oracle)):
        raise AssertionError(f"{len(streams)} streams: execute, run_program and bnn.forward disagree on the "
                             f"first block")
    return want


def check_fleet_outputs(label: str, res, streams: list, want: np.ndarray) -> None:
    """Every stream's outputs are its rows of ``want``, and the per-stream
    counts and bit counts are those of the outputs."""
    lengths = np.array([len(s) for s in streams])
    if not np.array_equal(res.per_stream_packets, lengths):
        raise AssertionError(f"{label}: per-stream packets disagree with the streams' lengths")
    starts = np.cumsum(lengths) - lengths
    for i, (a, n) in enumerate(zip(starts, lengths)):
        if not np.array_equal(res.outputs[i], want[a:a + n]):
            raise AssertionError(f"{label}: stream {i} ({n} packets, outputs {res.outputs[i].shape}) disagrees "
                                 f"with executor.execute")
    if hasattr(res, "bit_counts") and not np.array_equal(res.bit_counts, want.sum(axis=0, dtype=np.int64)):
        raise AssertionError(f"{label}: bit counts {res.bit_counts} disagree with the outputs")


def fleet_block_times(dev, lp, streams: list) -> dict:
    """Mean ms a block of each step of an ``execute_fleet`` pass (packed
    backend), each ended by a synchronise: the block's assembly
    (``fleet_blocks``), its copy to the card, the dispatch, the copy of
    its output bits to the host, and the bit counts."""
    fn = fleet.fleet_fn(lp, backend="packed", device=dev)
    steps = dict.fromkeys(("ingest", "to_device", "dispatch", "to_host", "accounting"), 0.0)
    blocks = 0
    mark = time.perf_counter()
    for block, valid in fleet.fleet_blocks(fleet._normalize_streams(streams, None), FLEET_CHUNK, lp.input_bits):
        t = [time.perf_counter()]
        dev_block = executor._to_device(block, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = fn(dev_block)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        res = out.cpu().numpy()
        t.append(time.perf_counter())
        fleet.block_bit_counts(res, valid)
        t.append(time.perf_counter())
        for name, a, b in zip(steps, [mark, *t], t):
            steps[name] += b - a
        blocks += 1
        mark = time.perf_counter()
    return {name: 1e3 * v / blocks for name, v in steps.items()}


def drive_fleet(dev, prog, lp, params, records: dict) -> None:
    """The fleet phase (module docstring, step 6)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2, (FLEET_CHUNK * FLEET_BLOCKS, HEADLINE.input_bits)).astype(np.int32)
    fleet_check_kernels(dev, lp, x, records)

    # Timing, as benchmarks/fleet_bench.py times it: replicas of one array,
    # each run twice and the second timed.
    x1 = np.tile(x, (10, 1))
    for rep in range(2):
        sr, launches = fleet_run("one stream", lp, "packed", lambda: executor.execute_stream(
            lp, iter([x1]), backend="packed", chunk_size=FLEET_CHUNK, device=dev), records)
    single = sr.packets_per_second
    print(f"fleet, one stream at chunk {FLEET_CHUNK}: {sr.packets} packets in {sr.chunks} chunks, "
          f"{sr.packets_per_second} pkt/s, {1e6 * sr.seconds / sr.chunks} us per chunk (warm-up "
          f"{sr.warmup_seconds} s); launches (count, by route) {launches}")
    runs = [("packed", s) for s in FLEET_STREAMS] + [("jnp", s) for s in FLEET_OPTABLE]
    for backend, streams in runs:
        plan = ExecutionPlan(backend=backend, chunk_size=FLEET_CHUNK)
        reps = [x] * streams
        t0 = time.perf_counter()
        for _ in fleet.fleet_blocks(fleet._normalize_streams(reps, None), FLEET_CHUNK, x.shape[1]):
            pass
        ingest = time.perf_counter() - t0
        for rep in range(2):
            t0 = time.perf_counter()
            fr, launches = fleet_run(f"fleet of {streams}, {backend}", lp, backend,
                                     lambda: fleet.execute_fleet(lp, reps, plan=plan, device=dev), records)
            call = time.perf_counter() - t0
        rf = roofline.probe_fleet(lp, backend=backend, streams=streams, chunk=FLEET_CHUNK)
        print(f"fleet of {streams}, {'packed' if backend == 'packed' else 'op-table'}: {fr.packets} packets in "
              f"{fr.chunks} blocks, {fr.packets_per_second} pkt/s ({fr.packets_per_second / single} x one "
              f"stream), {1e6 * fr.seconds / fr.chunks} us per block (warm-up {fr.warmup_seconds} s); call "
              f"{call} s = execute {fr.seconds} + warm-up {fr.warmup_seconds} + ingest {ingest} (fleet_blocks "
              f"alone) + copies and accounting {call - fr.seconds - fr.warmup_seconds - ingest}; launches "
              f"(count, by route) {launches}")
        print("  " + probe_line(rf, fr.packets_per_second))
        if backend == "packed" and streams >= 4096:
            print(f"  one pass, each step synchronised, ms a block: {fleet_block_times(dev, lp, reps)}")

    # Correctness: distinct streams (uniform bits seeded by stream index) of
    # unequal lengths, 0 to FLEET_CHUNK * FLEET_BLOCKS packets.
    t0 = time.perf_counter()
    lengths = [(i * 7919) % (FLEET_CHUNK * FLEET_BLOCKS + 1) for i in range(FLEET_STREAMS[-1])]
    distinct = [traffic.generate("uniform_random", n, HEADLINE.input_bits, seed=i) for i, n in enumerate(lengths)]
    print(f"fleet: {len(distinct)} distinct streams, {sum(lengths)} packets, made in {time.perf_counter() - t0} s")
    for streams in (FLEET_GATE, FLEET_STREAMS[-1]):
        mine = distinct[:streams]
        want = fleet_wants(dev, prog, lp, params, mine)
        for backend in ("packed", "jnp"):
            plan = ExecutionPlan(backend=backend, chunk_size=FLEET_CHUNK, collect=True)
            label = f"fleet of {streams} distinct streams, {'packed' if backend == 'packed' else 'op-table'}"
            fr, _ = fleet_run(label, lp, backend, lambda: fleet.execute_fleet(lp, mine, plan=plan, device=dev),
                              records)
            check_fleet_outputs(label, fr, mine, want)
            via_plan, _ = fleet_run(label + " (plan.run)", lp, backend, lambda: plan_run(
                lp, mine, plan=dataclasses.replace(plan, fleet=streams), device=dev), records)
            check_fleet_outputs(label + " (plan.run)", via_plan, mine, want)
        print(f"fleet of {streams} distinct streams: both backends and plan.run bit-exact with executor.execute on "
              f"every stream; first block == run_program == bnn.forward")

        # FleetEngine: the distinct streams (observability on, an SLO set),
        # then replicas of x twice, the second timed.
        slo = SloSpec("fleet", p99_queue_delay_s=0.01, min_pps=1e6)
        eng = FleetEngine(lp, plan=ExecutionPlan(backend="packed", chunk_size=FLEET_CHUNK), slo=slo, device=dev)
        obs.enable(reset=True)
        try:
            served, _ = fleet_run(f"FleetEngine, {streams} distinct streams", lp, "packed",
                                  lambda: eng.serve(mine, collect=True), records)
        finally:
            obs.disable()
            obs.reset()
        check_fleet_outputs(f"FleetEngine, {streams} distinct streams", served, mine, want)
        health = eng.health()
        rf = roofline.probe_fleet(lp, backend="packed", streams=streams, chunk=FLEET_CHUNK)
        if health.roofline_pps_bound != rf.roofline_pps:
            raise AssertionError(f"FleetEngine health bound {health.roofline_pps_bound}, probe {rf.roofline_pps}")
        print(health.render())
        for rep in range(2):
            sv, launches = fleet_run(f"FleetEngine, {streams} replicas", lp, "packed",
                                     lambda: eng.serve([x] * streams), records)
        print(f"FleetEngine, fleet of {streams}, packed: {sv.packets} packets in {sv.chunks} blocks, wall "
              f"{sv.wall_seconds} s -> {sv.packets_per_second} pkt/s; ingest {sv.ingest_seconds} s, execute "
              f"{sv.execute_seconds} s, overlap ratio {sv.overlap_ratio}, warm-up {sv.warmup_seconds} s; "
              f"launches (count, by route) {launches}")
        print("  " + probe_line(rf, sv.packets_per_second))
        alive = [t.name for t in threading.enumerate() if t.name == "fleet-ingest"]
        if alive:
            raise AssertionError(f"FleetEngine left {len(alive)} ingest thread(s) alive")
    print(f"fleet: every FleetEngine serve bit-exact with executor.execute; no fleet-ingest thread alive")


def drive_train_deploy(dev, records: dict) -> None:
    """Train the default BNN on the card, export it, and prove it bit-exact
    across a TRAIN_HOPS-switch fabric on both backends."""
    torch.cuda.synchronize()
    zero_counts()
    trainer = BnnTrainer(BnnTrainConfig(), device=dev)
    summary = trainer.train()
    held = trainer.evaluate_held_out()
    print(f"train: {trainer.cfg.layer_sizes}, {summary['final_step']} steps of batch {trainer.cfg.batch} in "
          f"{summary['seconds']} s -> {summary['steps_per_second']} steps/s; final loss "
          f"{summary['history'][-1]['loss']}; held-out accuracy {held['accuracy']} on {held['packets']} packets")
    if held["accuracy"] < TRAIN_MIN_ACCURACY:
        raise AssertionError(f"held-out accuracy {held['accuracy']} < {TRAIN_MIN_ACCURACY}")
    if read_counts():
        raise AssertionError(f"training launched a packet kernel: {read_counts()}")
    exported = trainer.export()
    ref_bits = trainer.forward_bits(trainer.eval_x)
    for backend in ("jnp", "packed"):
        rep = verify_roundtrip(exported, trainer.eval_x, mode="multi_hop", backend=backend,
                               reference_bits=ref_bits, check=False, device=dev)
        print(f"deploy ({backend}): {rep.summary()} in {rep.verify_seconds} s")
        if rep.hops != TRAIN_HOPS or not rep.ok or rep.reference_mismatches != 0:
            raise AssertionError(f"train -> deploy: {rep.summary()} (expected {TRAIN_HOPS} hops, 0 mismatches)")
    launches = read_counts()
    check_optable_route("train -> deploy", launches)
    count_path(records, "train -> deploy (verify_roundtrip)", launches)
    print(f"train -> deploy: launches {launches}")


# ---------------------------------------------------------------------------
# Multi-tenant switch scheduling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TenantPool:
    """Tenants' weights (the oracle's) and the fleet built from them
    (``dataplane.factory``: programs, traffic specs, and the shared chip that
    admits all of them in either merged layout)."""

    params: list
    fleet: Fleet

    @property
    def progs(self) -> list:
        return self.fleet.programs

    @property
    def specs(self) -> list:
        return self.fleet.traffic_specs


def tenant_pool(count: int, shapes=MT_SHAPES, scenarios=MT_SCENARIOS, weights=MT_WEIGHTS,
                seed: int = SEED) -> TenantPool:
    """Tenant i (``t{i}``): shape, scenario and weight by i (benchmarks/
    multitenant_bench.py:44-60), weights from ``bnn.init_params`` with
    generator seed ``seed + i``, built by ``build_fleet`` as ``program=``
    tenants; the factory's chip must be the one the benchmark sizes
    (:85-93)."""
    params, tenants = [], []
    for i in range(count):
        shape = shapes[i % len(shapes)]
        p = bnn.init_params(bnn.BnnSpec(shape), torch.Generator().manual_seed(seed + i))
        params.append(p)
        tenants.append(TenantSpec(f"t{i}", scenario=scenarios[i % len(scenarios)], weight=weights[i % len(weights)],
                                  program=compiler.compile_bnn([w.numpy() for w in p])))
    fleet = build_fleet(FleetSpec(tenants=tuple(tenants)))
    progs = fleet.programs
    chip = ChipSpec(
        num_elements=sum(p.num_elements for p in progs) + 1,
        phv_bits=sum(p.peak_phv_bits for p in progs),
        max_parallel_ops=max(MAX_FIELDS, lowering.peak_stage_rows([lowering.lower_program(p) for p in progs])),
        name="shared",
    )
    if fleet.chip != chip:
        raise AssertionError(f"build_fleet sized {fleet.chip}, the benchmark {chip}")
    if [s.input_bits for s in fleet.traffic_specs] != [shapes[i % len(shapes)][0] for i in range(count)]:
        raise AssertionError("build_fleet's traffic specs disagree with the tenants' shapes")
    return TenantPool(params, fleet)


def arrivals(tids: np.ndarray, bits: np.ndarray, chunk: int):
    """The mixed stream as it arrives: chunks of ``chunk`` packets."""
    return ((tids[i:i + chunk], bits[i:i + chunk]) for i in range(0, len(tids), chunk))


def tenant_wants(dev, pool: TenantPool, tids, bits, first: int) -> list:
    """Each tenant's outputs from its own ``executor.execute`` on the card;
    on its packets among the first ``first`` they must also be the
    interpreter's and the BNN oracle's."""
    wants = []
    for t, (prog, p) in enumerate(zip(pool.progs, pool.params)):
        mine = bits[tids == t, :prog.input_bits]
        want = executor.execute(prog.lower(), mine, chunk_size=CHUNK, device=dev)
        head = torch.from_numpy(np.ascontiguousarray(bits[:first][tids[:first] == t, :prog.input_bits])).to(dev)
        k = head.shape[0]
        if k:
            witness = interpreter.run_program(prog, head, device=dev).cpu().numpy()
            oracle = bnn.forward([w.to(dev) for w in p], head).cpu().numpy()
            if not (np.array_equal(want[:k], witness) and np.array_equal(witness, oracle)):
                raise AssertionError(f"tenant {t}: execute, run_program and bnn.forward disagree on "
                                     f"its {k} packets of the first chunk")
        wants.append(want)
    return wants


def expected_launches(sched: SwitchScheduler, res, backend: str, layout) -> dict:
    """The launches a scheduler run's path makes: per merged chunk (plus the
    warm call), or per time-sliced turn (plus each tenant's warm call)."""
    if res.mode == "merged":
        runs = res.chunks + 1
        if backend == "jnp":
            return {"optable_run": runs}
        if layout == "interleave":
            depth = len(executor.stack_tenant_layers([t.lowered for t in sched.tenants]))
            return {"pack_bits_words": depth * runs, "packed_layer_routed": depth * runs}
        layers = sched.merged(layout).lowered.packed.layers
        trivial = sum(executor._trivial_layout(pl) for pl in layers)
        return {k: v for k, v in (("pack_bits_words", trivial * runs), ("packed_layer", len(layers) * runs)) if v}
    turns = {t.tid: res.stats_for(t.tid).slices + 1 for t in sched.tenants if res.stats_for(t.tid).slices}
    if backend == "jnp":
        return {"optable_run": sum(turns.values())}
    n = sum(len(sched.tenants[t].lowered.packed.layers) * k for t, k in turns.items())
    return {"pack_bits_words": n, "packed_layer": n}


def layer_routes(layers, runs: int) -> dict:
    """``packed_layer``'s launches by route when each of ``layers`` runs
    ``runs`` times on words it allocates (so aligned)."""
    want = dict.fromkeys(packed_layer.ROUTES, 0)
    for pl in layers:
        path = packed_layer.route(torch.empty((0, pl.n_words), dtype=torch.int32),
                                  torch.empty(tuple(pl.weights.shape), dtype=torch.int32))
        want[path] += runs
    return want


def expected_layer_routes(sched: SwitchScheduler, res, layout) -> dict:
    """``packed_layer``'s launches by route on a packed run that is not
    interleaved: the block-diagonal merged layers per chunk (plus the warm
    call), or each tenant's layers per turn (plus its warm call)."""
    if res.mode == "merged":
        return layer_routes(sched.merged(layout).lowered.packed.layers, res.chunks + 1)
    want = dict.fromkeys(packed_layer.ROUTES, 0)
    for t in sched.tenants:
        slices = res.stats_for(t.tid).slices
        for path, n in layer_routes(t.lowered.packed.layers, slices + 1 if slices else 0).items():
            want[path] += n
    return want


def serve(dev, label: str, sched: SwitchScheduler, tids, bits, wants, records: dict, *, mode, layout,
          backend, chunk=MT_CHUNK, optable_route="shared"):
    """One scheduler run with every launch count zeroed just before and read
    just after; holds each tenant to ``wants`` and to conservation, every
    ``optable_run`` launch to ``optable_route``, every
    ``packed_layer_routed`` launch to the quad route and ``packed_layer``'s
    launches to each layer's route."""
    torch.cuda.synchronize()
    zero_counts()
    res = sched.run(arrivals(tids, bits, chunk), mode=mode, merged=layout, backend=backend,
                    chunk_size=chunk, device=dev)
    launches = read_counts()
    expect = expected_launches(sched, res, backend, layout)
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected {expect}")
    check_optable_route(label, launches, optable_route)
    by_route = packed_layer.packed_layer_routed.launches_by_route
    if by_route["quad"] != launches.get("packed_layer_routed", 0):
        raise AssertionError(f"{label}: packed_layer_routed launches by route {by_route}, expected all on quad")
    layer_by_route = dict(packed_layer.packed_layer.launches_by_route)
    if "packed_layer" in launches and layer_by_route != expected_layer_routes(sched, res, layout):
        raise AssertionError(f"{label}: packed_layer launches by route {layer_by_route}, expected "
                             f"{expected_layer_routes(sched, res, layout)}")
    for st in res.tenants:
        if st.packets != st.served + st.dropped or st.dropped or st.packets != int((tids == st.tid).sum()):
            raise AssertionError(f"{label} tenant {st.tid}: {st.packets} arrived, {st.served} served, "
                                 f"{st.dropped} dropped")
        if wants is not None and not np.array_equal(res.outputs_for(st.tid), wants[st.tid]):
            bad = int((res.outputs_for(st.tid) != wants[st.tid]).any(axis=1).sum())
            raise AssertionError(f"{label} tenant {st.tid}: {bad} packets disagree with its own execute")
    count_path(records, label, launches)
    dispatches = res.chunks if res.mode == "merged" else sum(st.slices for st in res.tenants)
    pps = [st.packets_per_second for st in res.tenants]
    print(f"{label}: {res.packets} packets, {len(res.tenants)} tenants, {res.seconds} s -> "
          f"{res.packets_per_second} pkt/s; per tenant min {min(pps)} max {max(pps)} pkt/s; "
          f"{dispatches} dispatches, {1e6 * res.seconds / dispatches} us per dispatch; warm-up "
          f"{res.warmup_seconds} s; launches {launches}"
          + (f"; optable_run on {optable_route}" if "optable_run" in launches else "")
          + (f"; packed_layer by route {layer_by_route}" if "packed_layer" in launches else ""))
    return res


MERGED_REPS = 4   # launches a graph when a merged program's kernels are timed


def check_merged_kernels(dev, count: int, sched: SwitchScheduler, tids, bits, records: dict, *,
                         layouts=("interleave", "concat"), rows=(MT_CHUNK,), path: str = "shared",
                         layers: bool = True) -> None:
    """``optable_run`` on each merged layout's tables over the mixed
    stream's first packets routed into the merged register file, at each of
    ``rows`` packets: it must take route ``path`` and equal its plain
    version.  On the shared route it is timed with events; past it (``path``
    ``split``) the ``global`` route, forced, must equal it too, and the two
    are timed in turns as replayed graphs of MERGED_REPS launches (a chunk
    of 1024 on split is a few tens of microseconds, near the wrapper's own
    host time), beside the bound (the same work whatever the route).  With ``layers``,
    ``packed_layer`` on the block-diagonal merged layers (words scattered
    from the routed bits of the first MT_CHUNK packets) on the route the
    wrapper takes, against its plain version; a layer on the tiled route is
    held with the cached route, forced, and on the ``concat`` layout (the
    packed backend's) timed in turns with it (graphs of CHUNK_REPS
    launches) beside its bound.  Not counted as main-path launches."""
    idx = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)  # noqa: E731
    run = optable_exec.optable_run
    rec, layer_rec = records["optable_run"], records["packed_layer"]
    for layout in layouts:
        mp = sched.merged(layout)
        lp = mp.lowered
        t = executor._device_tables(lp, dev)
        tables = (*t.ops, t.first_write)
        plan, plan_records = optable_exec.prepare(tables, lp.num_regs)
        if optable_exec.route(plan, lp.num_regs) != path:
            raise AssertionError(f"{count} tenants merged {layout}: optable_run routes to "
                                 f"{optable_exec.route(plan, lp.num_regs)}, not {path}")
        for n in rows:
            d_tids, d_bits = torch.from_numpy(tids[:n]).to(dev), torch.from_numpy(bits[:n]).to(dev)
            regs = executor.parse_packets_routed(d_bits, d_tids, idx(mp.in_slot), idx(mp.in_shift),
                                                 idx(mp.in_valid), num_regs=lp.num_regs)
            want = optable_exec.optable_run_plain(regs, *tables)
            shape = f"{lp.num_regs} regs, {lp.opcode.shape} table, {int(plan.rows.sum())} true rows"
            if path == "split":
                sp, _ = optable_exec.prepare_split(tables, lp.num_regs)
                shape += (f", {sp.num_phases} phases of at most {sp.chains} chains, {sp.threads} threads and "
                          f"{sp.packets} packets a block")
            else:
                shape += f", scratch {plan.max_deferred}"
            err = same(f"optable_run merged {layout}, {count} tenants ({shape}, {n} packets, {path})",
                       routed(run, path, lambda: run(regs, *tables)), want)
            b_ms, b_by = optable_bound(lp, plan, n)
            key = f"{count}_tenants_{layout}_{{}}" + ("" if n == CHUNK else f"_chunk_{n}")
            if path == "shared":
                ms = {path: time_ms(run, regs, *tables, iters=10)}
            else:
                calls = {
                    "split": lambda: run(regs, *tables),
                    "global": lambda: optable_exec._launch(regs, plan, plan_records, "global"),
                }
                err = max(err, same(f"optable_run merged {layout}, {count} tenants, {n} packets, global (forced)",
                                    routed(run, "global", calls["global"]), want))
                ms = {name: v / MERGED_REPS for name, v in graphs_in_turns(
                    {name: repeated(call, MERGED_REPS) for name, call in calls.items()}, iters=10).items()}
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            for name, v in ms.items():
                rec[f"ms_{key.format(name)}"] = v
            rec[f"bound_ms_{key.format(path)}"] = b_ms
            print(f"    optable_run merged {layout}, {count} tenants: "
                  + ", ".join(f"{name} {v} ms" for name, v in ms.items())
                  + f" per chunk of {n}; bound {b_ms} ms ({b_by})")
        if not layers:
            continue
        n = MT_CHUNK
        d_tids, d_bits = torch.from_numpy(tids[:n]).to(dev), torch.from_numpy(bits[:n]).to(dev)
        h = executor.route_bits_in(d_bits, d_tids, idx(mp.packed_in_bit), idx(mp.in_valid),
                                   total_bits=lp.packed.input_bits)
        fn = packed_layer.packed_layer
        for li, pl in enumerate(lp.packed.layers):
            words = executor._scatter_words(h, idx(pl.in_word), idx(pl.in_shift), pl.n_words)
            args = (words, executor._i32(pl.weights).to(dev), executor._i32(pl.mask).to(dev),
                    executor._i32(pl.thresholds).to(dev))
            layer_path = packed_layer.route(*args[:2])
            if count == MT_OVER and li == 0 and layer_path != "tiled":
                raise AssertionError(f"{count} tenants merged {layout}: the {pl.n_out} x {pl.n_words}-word "
                                     f"block-diagonal layer routes to {layer_path}, not tiled")
            h = routed(fn, layer_path, lambda: fn(*args))
            want = packed_layer.packed_layer_plain(*args)
            err = same(f"packed_layer merged {layout}, {count} tenants, layer {li} ({pl.n_out} out, "
                       f"{pl.n_words} words, {n} packets, {layer_path})", h, want)
            if layer_path == "general" and count == 8 and layout == "concat":
                err = max(err, time_general_layer(f"8_tenants_concat_layer_{li}_chunk_{n}", args, layer_rec))
            if layer_path == "tiled":
                out = torch.empty_like(h)
                err = max(err, same(f"packed_layer merged {layout}, {count} tenants, layer {li}, cached (forced)",
                                    routed(fn, "cached", lambda: packed_layer._launch(*args, out, "cached")), want))
            if layer_path == "tiled" and layout == "concat":
                t_l = graphs_in_turns({name: repeated(lambda name=name: packed_layer._launch(*args, out, name),
                                                      CHUNK_REPS) for name in ("tiled", "cached")})
                b_ms, b_by = costs.packed_layer(*words.shape, pl.n_out).bound_ms()
                for name, v in t_l.items():
                    layer_rec[f"ms_{name}_{count}_tenants_{layout}_layer_{li}_chunk_{n}"] = v / CHUNK_REPS
                layer_rec[f"bound_ms_tiled_{count}_tenants_{layout}_layer_{li}_chunk_{n}"] = b_ms
                print(f"    packed_layer merged {layout}, {count} tenants, layer {li} ({pl.n_out} x {pl.n_words} "
                      f"words): tiled {t_l['tiled'] / CHUNK_REPS} ms, cached {t_l['cached'] / CHUNK_REPS} ms per "
                      f"chunk of {n}; bound {b_ms} ms ({b_by})")
            layer_rec["max_abs_err"] = max(layer_rec["max_abs_err"], err)


def check_packed_layer_routed(dev, pools: dict) -> dict:
    """``packed_layer_routed`` against its plain version on each pool's
    stacked layers (``executor.stack_tenant_layers``), the words packed from
    the mixed stream's first packets, at chunks of MT_CHUNK and CHUNK, on the
    route the wrapper takes (``quad``: every stacked layer has 4k neurons and
    1 or 2 words) and on ``general``, forced; pad neurons must never fire.
    ``pools`` holds every pool whose interleaved packed run is served.
    Both routes are timed per chunk (all of a chunk's layers) in turns as the
    device time of a replayed CUDA graph of CHUNK_REPS chunks."""
    fn, plain = packed_layer.packed_layer_routed, packed_layer.packed_layer_routed_plain
    err = 0
    chunks = {}
    for count, (lowereds, tids, bits) in pools.items():
        tables = [(executor._i32(w).to(dev), executor._i32(thr).to(dev), executor._i32(m).to(dev), nw)
                  for w, thr, m, nw in executor.stack_tenant_layers(lowereds)]
        for rows in (MT_CHUNK, CHUNK):
            ids = torch.from_numpy(tids[:rows]).to(dev)
            h = torch.from_numpy(bits[:rows]).to(dev)
            launches = []
            for li, (w, thr, m, nw) in enumerate(tables):
                h = torch.nn.functional.pad(h, (0, nw * 32 - h.shape[1])) if h.shape[1] < nw * 32 else h[:, :nw * 32]
                words = bitpack.pack_bits_words(h)
                want = plain(words, ids, w, m, thr)
                out = routed(fn, "quad", lambda: fn(words, ids, w, m, thr))
                general = routed(fn, "general", lambda: packed_layer._launch_routed(
                    words, ids, w, m, thr, torch.empty_like(want), "general"))
                pads = (thr == -1).sum(1)
                for path, got in (("quad", out), ("general", general)):
                    err = max(err, same(f"packed_layer_routed {count} tenants, layer {li} ({rows} packets, "
                                        f"tables {tuple(w.shape)}, {int(pads.sum())} pad neurons, {path})",
                                        got, want))
                if (out.bool() & (thr == -1)[ids.long()]).any():
                    raise AssertionError("packed_layer_routed: a pad neuron (threshold 0xFFFFFFFF) fired")
                launches.append((words, ids, w, m, thr, torch.empty_like(out)))
                h = out
            chunks[count, rows] = launches
    t = graphs_in_turns({f"{count} tenants, chunk {rows}, {path}": repeated(
        lambda ls=ls, path=path: [packed_layer._launch_routed(*a, path) for a in ls], CHUNK_REPS)
        for (count, rows), ls in chunks.items() for path in packed_layer.ROUTED_ROUTES})
    per_chunk = {name: v / CHUNK_REPS for name, v in t.items()}
    b_ms, b_by = costs.total(costs.packed_layer_routed(*words.shape, *w.shape[:2])
                             for words, ids, w, m, thr, out in chunks[8, CHUNK]).bound_ms()
    plain_ms = sum(time_ms(plain, *a[:5], iters=3) for a in chunks[8, CHUNK])
    print(f"  packed_layer_routed per chunk (all layers), graph replay: "
          + ", ".join(f"{name} {v} ms" for name, v in per_chunk.items())
          + f"; bound (8 tenants, chunk {CHUNK}) {b_ms} ms ({b_by}); plain {plain_ms} ms")
    quad = lambda count, rows: per_chunk[f"{count} tenants, chunk {rows}, quad"]  # noqa: E731
    return dict(
        source="src/repro_torch/csrc/packed_layer.cu",
        replaces="src/repro/dataplane/executor.py:839",
        max_abs_err=err, ms=quad(8, CHUNK), old_route_ms=per_chunk[f"8 tenants, chunk {CHUNK}, general"],
        ms_chunk_1024=quad(8, MT_CHUNK), ms_128_tenants=quad(MT_WIDE, CHUNK),
        ms_32_tenants=quad(MT_OVER, CHUNK), ms_32_tenants_chunk_1024=quad(MT_OVER, MT_CHUNK),
        ms_128_tenants_chunk_1024=quad(MT_WIDE, MT_CHUNK), route_ms=per_chunk,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
    )


def drive_capture_tenants(dev, records: dict) -> None:
    """examples/pcap_replay.py section 5 without training: a synthetic
    capture written as pcap and pcapng and read back, registered as a
    scenario, and served as one tenant of three."""
    pkts, ts, _ = pcap.synthesize_capture(PCAP_PACKETS, seed=SEED)
    for fmt, raw in (("pcap", pcap.write_pcap(pkts, ts)), ("pcapng", pcap.write_pcapng(pkts, ts))):
        cap = pcap.read_pcap(raw)
        if cap.fmt != fmt or cap.packets() != pkts or not np.allclose(cap.timestamps, ts, rtol=0, atol=1e-6):
            raise AssertionError(f"{fmt}: the capture does not read back as written")
        print(f"capture: {len(pkts)} packets, {len(raw)} bytes of {fmt}, read back equal")
    pcap.register_pcap_scenario(PCAP_SCENARIO, cap, overwrite=True)
    pool = tenant_pool(3, shapes=((64, 64, 1), (32, 16, 4), (24, 12, 4)),
                       scenarios=(PCAP_SCENARIO, "iot_telemetry", "ddos_burst"), weights=(2.0, 1.0, 1.0),
                       seed=SEED + 100)
    tids, bits = traffic.mixed_tenant_generate(pool.specs, 2 * PCAP_PACKETS, seed=SEED)
    wants = tenant_wants(dev, pool, tids, bits, PCAP_CHUNK)
    for mode, layout in (("merged", "interleave"), ("time_sliced", None)):
        for backend in ("packed", "jnp"):
            sched = pool.fleet.scheduler(quantum=PCAP_CHUNK)
            res = serve(dev, f"capture tenants, {mode}, {'packed' if backend == 'packed' else 'op-table'}",
                        sched, tids, bits, wants, records, mode=mode, layout=layout, backend=backend,
                        chunk=PCAP_CHUNK)
            served = res.stats_for(0).served
            replay = torch.from_numpy(traffic.generate(PCAP_SCENARIO, served, 64)).to(dev)
            oracle = bnn.forward([w.to(dev) for w in pool.params[0]], replay).cpu().numpy()
            if not np.array_equal(res.outputs_for(0), oracle):
                raise AssertionError(f"capture tenant ({mode}, {backend}) disagrees with its oracle")
    print(f"capture tenants: the capture tenant bit-exact with its oracle in both modes on both backends")


def drive_multitenant(dev, records: dict) -> None:
    """The multi-tenant phase (module docstring, step 8)."""
    pools = {}
    for count in (8, MT_WIDE, MT_OVER):
        t0 = time.perf_counter()
        pool = tenant_pool(count)
        tids, bits = traffic.mixed_tenant_generate(pool.specs, MT_PACKETS, seed=count)
        pools[count] = (pool, tids, bits)
        print(f"multi-tenant pool of {count}: programs and {MT_PACKETS} mixed packets in "
              f"{time.perf_counter() - t0} s")
    scheds = {count: pool.fleet.scheduler(quantum=MT_CHUNK) for count, (pool, _, _) in pools.items()}
    sched8 = scheds[8]
    # Every merged program that is served, held against its plain versions:
    # 8 tenants on the shared route; 32 in both layouts and 128 (op-table
    # only) past it, on the split route.
    check_merged_kernels(dev, 8, sched8, *pools[8][1:], records)
    check_merged_kernels(dev, MT_OVER, scheds[MT_OVER], *pools[MT_OVER][1:], records,
                         rows=(MT_CHUNK, CHUNK), path="split")
    check_merged_kernels(dev, MT_WIDE, scheds[MT_WIDE], *pools[MT_WIDE][1:], records, path="split",
                         layers=False)
    # The (8, 12, 6) tenant's 12 -> 6 layer at chunk 1024, as the
    # time-sliced packed dispatch serves it.
    tenant = MT_SHAPES.index((8, 12, 6))
    pl = pools[8][0].progs[tenant].lower().packed.layers[1]
    bits12 = torch.randint(0, 2, (MT_CHUNK, pl.n_in), generator=torch.Generator().manual_seed(SEED)).to(dev)
    args = (bitpack.pack_bits_words(bits12.to(torch.int32)), executor._i32(pl.weights).to(dev),
            executor._i32(pl.mask).to(dev), executor._i32(pl.thresholds).to(dev))
    records["packed_layer"]["max_abs_err"] = max(records["packed_layer"]["max_abs_err"], time_general_layer(
        f"tenant_{pl.n_in}_to_{pl.n_out}_chunk_{MT_CHUNK}", args, records["packed_layer"]))
    records["packed_layer_routed"] = check_packed_layer_routed(
        dev, {c: ([p.lower() for p in pools[c][0].progs], *pools[c][1:]) for c in (8, MT_WIDE, MT_OVER)})

    pool, tids, bits = pools[8]
    wants = tenant_wants(dev, pool, tids, bits, MT_CHUNK)
    for mode, layout in (("merged", "interleave"), ("merged", "concat"), ("time_sliced", None)):
        for backend in ("packed", "jnp"):
            name = f"{mode}/{layout}" if layout else mode
            serve(dev, f"8 tenants, {name}, {'packed' if backend == 'packed' else 'op-table'}", sched8,
                  tids, bits, wants, records, mode=mode, layout=layout, backend=backend)
    print(sched8.telemetry().render())

    pool, tids, bits = pools[MT_WIDE]
    wide_wants = tenant_wants(dev, pool, tids, bits, MT_CHUNK)
    wide = scheds[MT_WIDE]
    serve(dev, f"{MT_WIDE} tenants, merged/interleave, packed", wide, tids, bits, wide_wants, records,
          mode="merged", layout="interleave", backend="packed")

    # Past the shared route: 32 tenants' merged register file (1,833
    # registers) in both layouts on both backends, and 128 tenants' (7,081)
    # interleaved on the op-table backend.
    pool, tids, bits = pools[MT_OVER]
    wants = tenant_wants(dev, pool, tids, bits, MT_CHUNK)
    over = scheds[MT_OVER]
    num_regs = over.merged("interleave").lowered.num_regs
    if num_regs != MT_OVER_REGS:
        raise AssertionError(f"{MT_OVER} tenants merge to {num_regs} registers, not {MT_OVER_REGS}")
    for layout in ("interleave", "concat"):
        for backend in ("jnp", "packed"):
            serve(dev, f"{MT_OVER} tenants, merged/{layout}, {'packed' if backend == 'packed' else 'op-table'}",
                  over, tids, bits, wants, records, mode="merged", layout=layout, backend=backend,
                  optable_route="split")
    _, tids, bits = pools[MT_WIDE]
    serve(dev, f"{MT_WIDE} tenants, merged/interleave, op-table", wide, tids, bits, wide_wants, records,
          mode="merged", layout="interleave", backend="jnp", optable_route="split")
    drive_capture_tenants(dev, records)


# ---------------------------------------------------------------------------
# The LM slice
# ---------------------------------------------------------------------------

COUNTED = dryrun.KERNELS   # every kernel wrapper, by name


def zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
        for by in ("launches_by_route", "launches_by_dtype", "launches_by_mask", "launches_by_mode"):
            for key in getattr(fn, by, {}):
                getattr(fn, by)[key] = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items() if fn.launches}


def routed(fn, path: str, call):
    """``call()``, failing unless it launched ``fn`` exactly once, on
    ``path``; returns what ``call`` returned."""
    before = dict(fn.launches_by_route)
    out = call()
    moved = {p: fn.launches_by_route[p] - before[p] for p in before}
    if moved != {p: int(p == path) for p in before}:
        raise AssertionError(f"{fn.__name__}: expected one launch on route {path}, got {moved}")
    return out


BF16_ULP = 2.0 ** -7   # a bf16 value's last place, relative to the value, at most


def within_rounding(what: str, out: torch.Tensor, want: torch.Tensor, mean_abs_v: torch.Tensor, rel: float,
                    rms_limit: float | None = None) -> float:
    """Fail unless every element of attention output ``out`` is within
    ``rel`` x (|want| + the row's softmax-weighted mean of |v|) of its plain
    version ``want``, and (with ``rms_limit``) its error's RMS within
    ``rms_limit`` of the output's RMS; returns the max absolute difference."""
    torch.cuda.synchronize()
    if out.shape != want.shape or out.dtype != want.dtype:
        raise AssertionError(f"{what}: kernel gives {out.dtype} {tuple(out.shape)}, "
                             f"plain {want.dtype} {tuple(want.shape)}")
    diff = (out.float() - want.float()).abs()
    bound = rel * (want.float().abs() + mean_abs_v)
    worst = float((diff / bound).max().item())
    rms = float(diff.square().mean().sqrt().item()) / float(want.float().square().mean().sqrt().item())
    top = float(diff.max().item())
    if not (worst <= 1.0 and (rms_limit is None or rms <= rms_limit)):
        raise AssertionError(f"{what}: max abs diff {top}, {worst} of the element-wise bound (limit 1), "
                             f"RMS error {rms} of the output's RMS (limit {rms_limit})")
    print(f"  {what}: max abs diff {top}; at most {worst} of the element-wise bound ({rel} of |out| + mean "
          f"|v|, limit 1); RMS error {rms} of the output's RMS (limit {rms_limit})")
    return top


def close_attention(what: str, out: torch.Tensor, want: torch.Tensor, q, k, v, causal: bool) -> float:
    """Fail unless bf16 attention ``out`` is within what bf16 rounding allows
    of its plain version ``want`` at every element, and its error's RMS
    within 2**-6 of the output's RMS; returns the max absolute difference.

    The bound of an element is one bf16 ulp of the value (each side rounds
    its float32 result to bf16 once: half an ulp each) plus one ulp of the
    row's softmax-weighted mean of |v| (each side rounds the weights p to
    bf16 before the PV product, the kernel against its running max, the
    plain version against the row's max: at most 2**-8 of that mean each).
    A correct kernel's errors are random and sit far inside it; the RMS
    limit catches a fault spread thinly over many elements (a wrong scale,
    a share of the keys dropped), which the output's small values at
    S = 2048 would hide from an absolute tolerance."""
    mean_abs_v = flash_attention.flash_attention_plain(q.float(), k.float(), v.float().abs(), causal=causal)
    return within_rounding(what, out, want, mean_abs_v, BF16_ULP, 2 * BF16_ULP)


def close(what: str, out: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Fail unless ``out`` is within ``tol`` of ``want`` everywhere; returns
    the max absolute difference."""
    torch.cuda.synchronize()
    if out.shape != want.shape or out.dtype != want.dtype:
        raise AssertionError(f"{what}: kernel gives {out.dtype} {tuple(out.shape)}, "
                             f"plain {want.dtype} {tuple(want.shape)}")
    diff = float((out.float() - want.float()).abs().max().item())
    if not diff <= tol:
        raise AssertionError(f"{what}: max abs diff {diff} > {tol}")
    print(f"  {what}: max abs diff {diff} (tolerance {tol})")
    return diff


def lm_projections(cfg) -> list[tuple[int, int, int]]:
    """(K, N, launches per layer) of one attention block's packed projections:
    q, k and v, o, the FFN's up (gate and up for SwiGLU) and down."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    up = 2 if cfg.act == "swiglu" else 1
    return [(d, q, 1), (d, kv, 2), (q, d, 1), (d, cfg.d_ff, up), (cfg.d_ff, d, 1)]


def graph_of(fn):
    """A CUDA graph of ``fn()``'s launches, captured after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g


def repeated(fn, reps: int):
    """``fn()`` ``reps`` times in one call: a graph of it holds enough work
    that the device, not the host's replay call, sets its time."""
    return lambda: [fn() for _ in range(reps)]


def in_turns(fns: dict, what: str = "in turns", iters: int = 20) -> dict:
    """Mean ms of each no-argument call, timed in turns (each in order, then
    in reverse order) on one card."""
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        times[name].append(time_ms(fns[name], iters=iters))
    for name, ts in times.items():
        print(f"    {what}: {name} {ts[0]}, {ts[1]} ms")
    return {name: sum(ts) / len(ts) for name, ts in times.items()}


def graphs_in_turns(fns: dict, iters: int = 20) -> dict:
    """Mean ms of one replay of a CUDA graph of each no-argument call, timed
    in turns: the launches' device time, without the wrapper's host time
    between them."""
    return in_turns({name: graph_of(fn).replay for name, fn in fns.items()}, "graph replay in turns", iters)


DECODE_M = 4        # the Engine's slots: the M of every decode-step projection
GRAPH_LAYERS = 4    # distinct layers' weights per graph: 57 MB, beyond the 50 MB L2


def packed_operands(m: int, n: int, kw: int, k_bits: int, gen, dev) -> tuple:
    """Random packed words, zero past ``k_bits`` in both operands, with an
    all-ones and an all-zero row in each (where there are two rows)."""
    x, w = random_words((m, kw), gen, dev), random_words((n, kw), gen, dev)
    bit = torch.arange(32 * kw, device=dev).view(kw, 32)
    keep = ((bit < k_bits).to(torch.int64) << torch.arange(32, device=dev)).sum(-1)
    keep = bitops.u32_to_i32(keep)
    x, w = x & keep, w & keep
    x[0], w[0] = keep, 0
    if m > 1 and n > 1:
        x[1], w[1] = 0, keep
    return x, w


def check_bnn_matmul_packed(dev, cfg, gen) -> dict:
    """The packed GEMM bit for bit against its plain version at the decode
    (M = 4 slots, stream route), prefill (M = 17 and 128) and scoring (M =
    2048) shapes of every projection (mma route), at ragged M, N, Kw and
    k_bits with all-ones and all-zero words (mma, and tiled forced), and at
    ragged K through ``binary_matmul``.

    Timed per decode-step layer (the 7 projection launches at M = 4): back to
    back with events (the wrapper's host time included), and as the device
    time of a CUDA graph over GRAPH_LAYERS layers' distinct weights (so they
    stream from memory, as in a real step), in turns with the same graph on
    the tiled route and with ``torch.matmul`` of the pre-signed bf16 operands
    at the same seven shapes.  Then stream, mma and tiled at M of 1 to 16,
    the measurement behind ``bnn_matmul.STREAM_MAX_M``.  A prefill layer (M
    = 128, over GRAPH_LAYERS layers' weights) and a scoring layer (M = 2048)
    are timed as graph replays in turns: mma, tiled (forced), ``torch.matmul``
    of pre-signed bf16 (the library call) and ``torch._int_mm`` of +-1 int8,
    each beside the bound."""
    fn = bnn_matmul.bnn_matmul_packed
    err = 0
    ms = plain = prefill_ms = 0.0
    decode_costs = []
    for k, n, per_layer in lm_projections(cfg):
        wp, _ = kops.pack_weights(torch.randn((n, k), generator=gen, device=dev))
        for m, path in ((DECODE_M, "stream"), (17, "mma"), (128, "mma"), (LM_SCORE_LEN, "mma")):
            xp = kops._pack_rows(torch.randn((m, k), generator=gen, device=dev))
            tile = f", tile width {bnn_matmul.mma_block_n(m, n, 1, bnn_matmul._sm_count(xp.device))}"
            err = max(err, same(f"bnn_matmul_packed M={m} K={k} N={n} ({path}{tile if path == 'mma' else ''})",
                                routed(fn, path, lambda: fn(xp, wp, k_bits=k)),
                                ref.bnn_matmul_packed_ref(xp, wp, k)))
            if m == DECODE_M:
                ms += per_layer * time_ms(lambda: fn(xp, wp, k_bits=k))
                plain += per_layer * time_ms(ref.bnn_matmul_packed_ref, xp, wp, k, iters=3)
                decode_costs.append(per_layer * costs.bnn_matmul_packed(m, n, wp.shape[1]))
            elif m == 128:
                prefill_ms += per_layer * time_ms(lambda: fn(xp, wp, k_bits=k))
    print(f"  bnn_matmul_packed per layer, back to back: decode (M={DECODE_M}, stream) {ms} ms, "
          f"prefill (M=128, mma) {prefill_ms} ms")
    # Ragged M, N, Kw (not a multiple of the mma stage's 8 words) and
    # k_bits, a misaligned view (4-byte copies), and a K of one word.
    for m, n, kw, k_bits, shift in ((17, 3001, 99, 3163, 0), (2047, 1027, 13, 400, 0), (300, 77, 1, 1, 0),
                                    (33, 3072, 96, 3072, 1), (129, 4099, 12, 384, 3)):
        x, w = packed_operands(m, n, kw, k_bits, gen, dev)
        if shift:
            w = shifted(w, 4 * shift)
        want = ref.bnn_matmul_packed_ref(x, w, k_bits)
        err = max(err, same(f"bnn_matmul_packed M={m} N={n} Kw={kw} k_bits={k_bits}"
                            + (f", w {4 * shift} bytes past 16" if shift else "") + " (mma)",
                            routed(fn, "mma", lambda: fn(x, w, k_bits=k_bits)), want))
        out = torch.empty_like(want)
        err = max(err, same(f"bnn_matmul_packed M={m} N={n} Kw={kw} k_bits={k_bits} (tiled, forced)",
                            routed(fn, "tiled", lambda: bnn_matmul._launch(x, w.contiguous(), out, k_bits, "tiled")),
                            want))
    for k in (100, 513):
        x = torch.randn((37, k), generator=gen, device=dev)
        w = torch.randn((300, k), generator=gen, device=dev)
        err = max(err, same(f"binary_matmul pallas_packed K={k}",
                            kops.binary_matmul(x, w, implementation="pallas_packed"),
                            kops.binary_matmul(x, w, implementation="ref")))

    # One decode-step layer's seven projections, over GRAPH_LAYERS layers.
    shapes = [(k, n) for k, n, per_layer in lm_projections(cfg) for _ in range(per_layer)]
    packed_w = [[kops.pack_weights(torch.randn((n, k), generator=gen, device=dev))[0] for k, n in shapes]
                for _ in range(GRAPH_LAYERS)]
    signed_w = [[ref.sign(torch.randn((k, n), generator=gen, device=dev), torch.bfloat16)
                 for k, n in shapes] for _ in range(GRAPH_LAYERS)]

    def packed_layers(m, path, layers=GRAPH_LAYERS):
        xs = {k: kops._pack_rows(torch.randn((m, k), generator=gen, device=dev)) for k, _ in shapes}
        outs = [[torch.empty((m, n), dtype=torch.int32, device=dev) for _, n in shapes]
                for _ in range(layers)]
        for layer, layer_out in zip(packed_w, outs):
            for (k, _), wp, out in zip(shapes, layer, layer_out):
                if path == "stream" and bnn_matmul.route(xs[k], wp) != "stream":
                    raise AssertionError(f"M={m} K={k} cannot take the stream route")
        return lambda: [bnn_matmul._launch(xs[k], wp, out, k, path)
                        for layer, layer_out in zip(packed_w, outs)
                        for (k, _), wp, out in zip(shapes, layer, layer_out)]

    def matmul_layers(m, layers=GRAPH_LAYERS):
        xs = {k: ref.sign(torch.randn((m, k), generator=gen, device=dev), torch.bfloat16) for k, _ in shapes}
        return lambda: [torch.matmul(xs[k], w) for layer in signed_w[:layers] for (k, _), w in zip(shapes, layer)]

    def int_mm_layers(m, layers=GRAPH_LAYERS):
        # +-1 int8, the weights (N, K) row-major read as (K, N): the layout
        # torch._int_mm's int8 kernels take.
        xs = {k: ref.sign(torch.randn((m, k), generator=gen, device=dev), torch.int8) for k, _ in shapes}
        ws = [[ref.sign(torch.randn((n, k), generator=gen, device=dev), torch.int8).T for k, n in shapes]
              for _ in range(layers)]
        return lambda: [torch._int_mm(xs[k], w) for layer in ws for (k, _), w in zip(shapes, layer)]

    t = graphs_in_turns({"stream": packed_layers(DECODE_M, "stream"),
                         "tiled": packed_layers(DECODE_M, "tiled"), "torch.matmul": matmul_layers(DECODE_M)})
    graph_ms = {name: v / GRAPH_LAYERS for name, v in t.items()}
    print(f"  bnn_matmul_packed per decode layer (M={DECODE_M}), graph replay: stream "
          f"{graph_ms['stream']} ms, tiled {graph_ms['tiled']} ms, torch.matmul bf16 "
          f"{graph_ms['torch.matmul']} ms; back to back (events) {ms} ms")
    sweep = {}
    for m in (1, 2, 4, 8, 12, 16):
        s_ms = graphs_in_turns({f"{path} M={m}": packed_layers(m, path) for path in ("stream", "mma", "tiled")},
                               iters=10)
        sweep[m] = {path: v / GRAPH_LAYERS for path, v in zip(("stream", "mma", "tiled"), s_ms.values())}
    print(f"  route sweep, ms per layer by M (graph replay): {json.dumps(sweep)}")
    b_ms, b_by = costs.total(decode_costs).bound_ms()
    rec = dict(source="src/repro_torch/csrc/bnn_matmul.cu",
               replaces="src/repro/kernels/bnn_matmul.py:56",
               max_abs_err=err, ms=graph_ms["stream"], plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
               library_ms=graph_ms["torch.matmul"], decode_ms_tiled_forced=graph_ms["tiled"],
               route_sweep_ms=sweep)
    # A prefill layer (M = 128, 4 layers' weights a graph: beyond the L2) and
    # a scoring layer (M = 2048, one layer's weights), in turns.
    for label, m, layers in (("prefill", 128, GRAPH_LAYERS), ("scoring", LM_SCORE_LEN, 1)):
        calls = {"mma": packed_layers(m, "mma", layers), "tiled (forced)": packed_layers(m, "tiled", layers),
                 "torch.matmul bf16": matmul_layers(m, layers), "torch._int_mm int8": int_mm_layers(m, layers)}
        t = {name: v / layers for name, v in graphs_in_turns(calls, iters=10).items()}
        lb_ms, lb_by = costs.total(per * costs.bnn_matmul_packed(m, n, k // 32)
                                   for k, n, per in lm_projections(cfg)).bound_ms()
        print(f"  bnn_matmul_packed per {label} layer (M={m}, 7 launches), graph replay: "
              + ", ".join(f"{name} {v} ms" for name, v in t.items()) + f"; bound {lb_ms} ms ({lb_by})")
        rec.update({f"{label}_layer_ms_mma": t["mma"], f"{label}_layer_ms_tiled_forced": t["tiled (forced)"],
                    f"{label}_layer_library_ms_torch_matmul": t["torch.matmul bf16"],
                    f"{label}_layer_ms_torch_int_mm": t["torch._int_mm int8"],
                    f"{label}_layer_bound_ms": lb_ms, f"{label}_layer_bound_by": lb_by})
    del signed_w, packed_w
    return rec


def check_bnn_matmul_mxu(dev, cfg, gen) -> dict:
    """The tensor-core GEMM bit for bit against its plain version at a
    prefill-sized activation times phi3's up projection (2048 x 3072 x 8192,
    the tma route), at a ragged shape on each route, and at -0.0 and NaN
    signs; timed at the first, in turns with ``torch.matmul`` of the signed
    bf16 operands."""
    mxu, plain = bnn_matmul_mxu.bnn_matmul_mxu, bnn_matmul_mxu.bnn_matmul_mxu_plain
    m, k, n = LM_SCORE_LEN, cfg.d_model, cfg.d_ff
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = ref.sign(torch.randn((k, n), generator=gen, device=dev), torch.bfloat16)
    err = same(f"bnn_matmul_mxu {m}x{k}x{n} bf16 (tma)", routed(mxu, "tma", lambda: mxu(x, w)), plain(x, w))
    xt = torch.randn((1000, 520), generator=gen, device=dev).to(torch.bfloat16)
    xt[0, :3] = torch.tensor([-0.0, float("nan"), 0.0])
    wt = ref.sign(torch.randn((520, 264), generator=gen, device=dev), torch.bfloat16)
    err = max(err, same("bnn_matmul_mxu 1000x520x264 bf16 (tma, ragged M, N, K)",
                        routed(mxu, "tma", lambda: mxu(xt, wt)), plain(xt, wt)))
    xr = torch.randn((1000, 513), generator=gen, device=dev)
    wr = ref.sign(torch.randn((513, 300), generator=gen, device=dev), torch.bfloat16)
    err = max(err, same("bnn_matmul_mxu 1000x513x300 f32 (staged)",
                        routed(mxu, "staged", lambda: mxu(xr, wr)), plain(xr, wr)))
    # Each sign site (the tma route's bf16x2 compare, the staged route's bf16
    # and float32 staging) on planted subnormal signs.
    cpu_gen = torch.Generator().manual_seed(SEED)
    for dtype, kk, path in ((torch.bfloat16, 520, "tma"), (torch.bfloat16, 513, "staged"),
                            (torch.float32, 520, "staged")):
        xp = planted((1000, kk), dtype, cpu_gen, dev)
        wp = ref.sign(torch.randn((kk, 264), generator=gen, device=dev), torch.bfloat16)
        err = max(err, same(f"bnn_matmul_mxu 1000x{kk}x264 {dtype} with subnormal signs ({path})",
                            routed(mxu, path, lambda: mxu(xp, wp)), plain(xp, wp)))
    xs = ref.sign(x, torch.bfloat16)
    b_ms, b_by = costs.bnn_matmul_mxu(m, k, n).bound_ms()
    t = in_turns({"kernel": lambda: mxu(x, w), "library": lambda: torch.matmul(xs, w)})
    return dict(source="src/repro_torch/csrc/bnn_matmul_mxu.cu",
                replaces="src/repro/kernels/bnn_matmul_mxu.py:45",
                max_abs_err=err, ms=t["kernel"],
                plain_ms=time_ms(plain, x, w, iters=5),
                bound_ms=b_ms, bound_by=b_by, library_ms=t["library"])


def check_flash(dev, cfg, gen) -> dict:
    """Flash attention against its plain version: the scoring path's shape
    (BH = 32 heads, S = 2048, D = 96, bf16, causal; the tma route), smaller
    bf16 cases (full attention, ragged S, and D = 20 on the wmma route), and
    the scoring layers of hubert-xlarge (16 heads, S = 2048, D = 80, full),
    zamba2-1.2b (32 heads, D = 64, causal) and internvl2-2b (16 heads,
    D = 128, causal), bf16 within ``close_attention``'s bound; float32
    causal and full cases within 1e-5; each asserts its route.  Timed at
    the first and at hubert's layer, each in turns with
    ``scaled_dot_product_attention``."""
    fa, plain = flash_attention.flash_attention, flash_attention.flash_attention_plain
    bh, s, d = cfg.num_heads, LM_SCORE_LEN, cfg.resolved_head_dim

    def qkv(shape, dtype):
        return (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))

    def scoring_layer(arch):
        c = get_config(arch)
        return c.num_heads, LM_SCORE_LEN, c.resolved_head_dim

    q, k, v = qkv((bh, s, d), torch.bfloat16)
    err = close_attention(f"flash_attention ({bh}, {s}, {d}) bf16 causal (tma)",
                          routed(fa, "tma", lambda: fa(q, k, v)), plain(q, k, v), q, k, v, True)
    full_d80 = scoring_layer(AUDIO_ARCH)   # hubert's scoring layer
    for shape, causal, path in (((8, 1024, d), False, "tma"), ((4, 300, d), True, "tma"),
                                ((4, 300, 20), True, "wmma"), (full_d80, False, "tma"),
                                (scoring_layer(HYBRID_ARCH), True, "tma"),
                                (scoring_layer(VLM_ARCH), True, "tma")):
        qb, kb, vb = qkv(shape, torch.bfloat16)
        err = max(err, close_attention(f"flash_attention {shape} bf16 causal={causal} ({path})",
                                       routed(fa, path, lambda: fa(qb, kb, vb, causal=causal)),
                                       plain(qb, kb, vb, causal=causal), qb, kb, vb, causal))
    for causal in (True, False):
        qf, kf, vf = qkv((4, 300, d), torch.float32)
        err = max(err, close(f"flash_attention (4, 300, {d}) f32 causal={causal} (f32)",
                             routed(fa, "f32", lambda: fa(qf, kf, vf, causal=causal)),
                             plain(qf, kf, vf, causal=causal), 1e-5))
    q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b_ms, b_by = costs.flash_attention(bh, s, d).bound_ms()
    t = in_turns({"kernel": lambda: fa(q, k, v), "library": lambda: sdpa(q4, k4, v4, is_causal=True)})
    # hubert-xlarge's layer: full (bidirectional) attention at D = 80
    qa, ka, va = qkv(full_d80, torch.bfloat16)
    qa4, ka4, va4 = (x.view(1, *full_d80) for x in (qa, ka, va))
    a_ms, a_by = costs.flash_attention(*full_d80, causal=False).bound_ms()
    ta = in_turns({"kernel full D=80": lambda: fa(qa, ka, va, causal=False),
                   "library full D=80": lambda: sdpa(qa4, ka4, va4)})
    return dict(source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:72",
                max_abs_err=err, ms=t["kernel"],
                plain_ms=time_ms(plain, q, k, v, iters=5),
                bound_ms=b_ms, bound_by=b_by, library_ms=t["library"],
                full_d80_ms=ta["kernel full D=80"], full_d80_bound_ms=a_ms, full_d80_bound_by=a_by,
                full_d80_library_ms=ta["library full D=80"],
                full_d80_plain_ms=time_ms(lambda: plain(qa, ka, va, causal=False), iters=5))


PREFILL_LONG = 32768   # the dry run's prefill_32k prompt
ATTN_Q_CHUNK = 1024    # the configs' attn_q_chunk: the plain version's query chunk
SDPA_NOTE = ("torch.nn.functional.scaled_dot_product_attention at the same shapes (enable_gqa; decode on the "
             "cache sliced to index + 1 keys): a timed yardstick the port never calls, with its own roundings "
             "(p is not rounded to bf16 before PV, scores not rounded to bf16)")


def attention_shape(arch: str) -> tuple[int, int, int, int]:
    """(H, KVH, Dqk, Dv) of ``arch``'s attention: MLA's query heads read
    their own expanded K and V."""
    c = get_config(arch)
    if c.attention == "mla":
        return c.num_heads, c.num_heads, c.mla.qk_nope_dim + c.mla.qk_rope_dim, c.mla.v_head_dim
    return c.num_heads, c.num_kv_heads, c.resolved_head_dim, c.resolved_head_dim


def sdpa_gqa(q, k, v, causal: bool):
    """``scaled_dot_product_attention`` on (B, S, heads, D) operands."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
        enable_gqa=q.shape[2] != k.shape[2])


def check_chunked(dev, gen) -> dict:
    """``chunked_attention`` against its plain version on the card: phi3's
    prefill at S = 2048 and PREFILL_LONG (bf16, causal), S = 2048 with bf16
    scores, qwen3-moe's GQA (G 8, D 128) at 2048 and PREFILL_LONG,
    deepseek-v2's and minicpm3's MLA (Dqk 192 / Dv 128 and 96 / 64) and a
    full (non-causal) ragged case, each on the tma route and on the first
    design's mma route (forced); one float32 case (the f32 route); bf16 within
    ``within_rounding``'s bf16 bound (one ulp of |out| + the
    softmax-weighted mean |v|) and RMS limit, float32 within 1e-5 of the
    same (the sums are in another order).  Timed at phi3's two prefills and
    qwen3-moe's long one: tma, mma (forced), SDPA and (but at qwen3's)
    plain, graphs in turns at 2048, events in turns at PREFILL_LONG."""
    fn, plain = chunked_kernel.chunked_attention, chunked_kernel.chunked_attention_plain

    def qkv(b, s, shape, dtype):
        h, kvh, dqk, dv = shape
        return tuple(torch.randn(x, generator=gen, device=dev).to(dtype)
                     for x in ((b, s, h, dqk), (b, s, kvh, dqk), (b, s, kvh, dv)))

    def kwargs(q, causal=True, scores_dtype=torch.float32):
        return dict(causal=causal, q_chunk=ATTN_Q_CHUNK, scale=1.0 / q.shape[-1] ** 0.5, scores_dtype=scores_dtype)

    def on(path, q, k, v, kw):
        """The call that launches route ``path``: the wrapper on its own
        route, else the route forced."""
        if path == chunked_kernel.route(q, k, v):
            return lambda: fn(q, k, v, **kw)
        out = torch.empty((*q.shape[:3], v.shape[3]), dtype=q.dtype, device=q.device)
        launch_kw = {key: kw[key] for key in ("causal", "scale", "scores_dtype")}
        return lambda: chunked_kernel._launch(q, k, v, out, path, **launch_kw)

    def held(label, q, k, v, causal=True, scores_dtype=torch.float32):
        kw = kwargs(q, causal, scores_dtype)
        want = plain(q, k, v, **kw)
        mean_abs_v = plain(q.float(), k.float(), v.float().abs(), **kw)
        bf16 = q.dtype == torch.bfloat16
        err = 0.0
        for path in ("tma", "mma") if bf16 else ("f32",):
            out = routed(fn, path, on(path, q, k, v, kw))
            err = max(err, within_rounding(
                f"chunked_attention {label} {tuple(q.shape)} x {tuple(v.shape)} {q.dtype} causal={causal} "
                f"scores {scores_dtype} ({path})", out, want, mean_abs_v, BF16_ULP if bf16 else 1e-5,
                2 * BF16_ULP if bf16 else None))
            del out
        del want, mean_abs_v
        return err

    def long_prefill(arch, shape, with_plain):
        """Hold and time ``arch``'s prefill of PREFILL_LONG tokens."""
        q, k, v = qkv(1, PREFILL_LONG, shape, torch.bfloat16)
        err = held(f"{arch} prefill_32k", q, k, v)
        kw = kwargs(q)
        t = in_turns({"kernel": on("tma", q, k, v, kw), "mma": on("mma", q, k, v, kw),
                      "library": lambda: sdpa_gqa(q, k, v, True)}, f"{arch} S={PREFILL_LONG}", iters=3)
        t["plain"] = time_ms(lambda: plain(q, k, v, **kw), iters=1) if with_plain else None
        t["bound"], t["bound_by"] = costs.chunked_attention(1, PREFILL_LONG, PREFILL_LONG, *shape, True).bound_ms()
        print(f"  chunked_attention {arch} 1 x {PREFILL_LONG} x {shape}: tma {t['kernel']} ms, mma (forced) "
              f"{t['mma']} ms, plain {t['plain']} ms, SDPA {t['library']} ms, bound {t['bound']} ms ({t['bound_by']})")
        del q, k, v
        torch.cuda.empty_cache()
        return err, t

    phi3, qwen3 = attention_shape(LM_ARCH), attention_shape(MOE_ARCH)
    q, k, v = qkv(1, LM_SCORE_LEN, phi3, torch.bfloat16)
    err = held(f"{LM_ARCH} prefill", q, k, v)
    err = max(err, held(f"{LM_ARCH} +sbf16", q, k, v, scores_dtype=torch.bfloat16))
    for label, b, s, shape, causal, dtype in (
            (MOE_ARCH, 1, LM_SCORE_LEN, qwen3, True, torch.bfloat16),
            (MLA_ARCH, 1, LM_SCORE_LEN, attention_shape(MLA_ARCH), True, torch.bfloat16),
            ("minicpm3-4b", 1, LM_SCORE_LEN, attention_shape("minicpm3-4b"), True, torch.bfloat16),
            ("ragged, full", 2, 300, phi3, False, torch.bfloat16),
            (f"{LM_ARCH} float32", 1, LM_SCORE_LEN, phi3, True, torch.float32)):
        err = max(err, held(label, *qkv(b, s, shape, dtype), causal=causal))
    kw = kwargs(q)
    t = graphs_in_turns({"kernel": on("tma", q, k, v, kw), "mma": on("mma", q, k, v, kw),
                         "plain": lambda: plain(q, k, v, **kw), "library": lambda: sdpa_gqa(q, k, v, True)})
    b_ms, b_by = costs.chunked_attention(1, LM_SCORE_LEN, LM_SCORE_LEN, *phi3, True).bound_ms()
    rec = dict(ms_s2048=t["kernel"], mma_ms_s2048=t["mma"], plain_ms_s2048=t["plain"],
               library_ms_s2048=t["library"], bound_ms_s2048=b_ms, bound_by_s2048=b_by)
    print(f"  chunked_attention {LM_ARCH} 1 x {LM_SCORE_LEN} x {phi3}: {rec}")
    del q, k, v
    e, t = long_prefill(LM_ARCH, phi3, True)
    err = max(err, e)
    e, tq = long_prefill(MOE_ARCH, qwen3, False)
    err = max(err, e)
    rec.update(ms_qwen3_32k=tq["kernel"], mma_ms_qwen3_32k=tq["mma"], library_ms_qwen3_32k=tq["library"],
               bound_ms_qwen3_32k=tq["bound"], bound_by_qwen3_32k=tq["bound_by"])
    return dict(source="src/repro_torch/csrc/chunked_attention.cu",
                replaces="src/repro/layers/attention.py:104-152 (jnp chunked_attention)",
                max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"], bound_ms=t["bound"], bound_by=t["bound_by"],
                library_ms=t["library"], library_call=SDPA_NOTE, mma_ms=t["mma"],
                routes_timed="ms, ms_*: tma (the served route); mma_ms*: the first design's mma route, forced",
                shape=f"1 x {PREFILL_LONG} x {phi3}", **rec)


def check_decode(dev, gen) -> dict:
    """``decode_attention`` against its plain version on the card: phi3's
    incremental mode at DECODE_M slots over a cache of PREFILL_LONG
    positions at index 0, 128 and PREFILL_LONG - 1 (bf16) and one float32
    case; qwen3-moe (G 8) and chatglm3 (G 16) in the in-cache mode at index
    0 and S_max - 1; within ``within_rounding``'s bound (one bf16 ulp, or
    1e-5 for float32, of |out| + the softmax-weighted mean |v|: float32 sums
    in another order, one rounding to the output's type).  Timed as graphs
    in turns (kernel, plain, SDPA on the cache sliced to index + 1 keys) at
    phi3's PREFILL_LONG - 1 (the decode_32k layer), phi3's 128, chatglm3's
    S_max - 1 and qwen3-moe's in-cache PREFILL_LONG - 1 (its decode_32k
    layer), which is also held against plain."""
    fn, plain = decode_kernel.decode_attention, decode_kernel.decode_attention_plain

    def caches(shape, s_max, dtype):
        h, kvh, d, dv = shape
        q = torch.randn((DECODE_M, 1, h, d), generator=gen, device=dev).to(dtype)
        kc = torch.randn((DECODE_M, s_max, kvh, d), generator=gen, device=dev).to(dtype)
        vc = torch.randn((DECODE_M, s_max, kvh, dv), generator=gen, device=dev).to(dtype)
        kn = torch.randn((DECODE_M, 1, kvh, d), generator=gen, device=dev).to(dtype)
        vn = torch.randn((DECODE_M, 1, kvh, dv), generator=gen, device=dev).to(dtype)
        return q, kc, vc, kn, vn

    def held(label, q, kc, vc, kn, vn, index, incremental):
        kw = dict(scale=1.0 / q.shape[-1] ** 0.5, k_new=kn if incremental else None,
                  v_new=vn if incremental else None)
        path = "bf16" if q.dtype == torch.bfloat16 else "f32"
        out = routed(fn, path, lambda: fn(q, kc, vc, index, **kw))
        want = plain(q, kc, vc, index, **kw)
        mean_abs_v = plain(q.float(), kc.float(), vc.float().abs(), index, scale=kw["scale"],
                           k_new=kn.float() if incremental else None, v_new=vn.float().abs() if incremental else None)
        bf16 = q.dtype == torch.bfloat16
        mode = "incremental" if incremental else "in_cache"
        return within_rounding(f"decode_attention {label} {tuple(q.shape)} over {tuple(kc.shape)} index {index} "
                               f"({mode}, {path})", out, want, mean_abs_v, BF16_ULP if bf16 else 1e-5)

    def timed(q, kc, vc, kn, vn, index, incremental):
        kw = dict(scale=1.0 / q.shape[-1] ** 0.5, k_new=kn if incremental else None,
                  v_new=vn if incremental else None)
        keys = index + 1
        ks, vs = kc[:, :keys], vc[:, :keys]
        return graphs_in_turns({"kernel": lambda: fn(q, kc, vc, index, **kw),
                                "plain": lambda: plain(q, kc, vc, index, **kw),
                                "library": lambda: sdpa_gqa(q, ks, vs, False)})

    phi3 = attention_shape(LM_ARCH)
    args = caches(phi3, PREFILL_LONG, torch.bfloat16)
    err = 0.0
    for index in (0, 128, PREFILL_LONG - 1):
        err = max(err, held(LM_ARCH, *args, index, True))
    t_long = timed(*args, PREFILL_LONG - 1, True)
    t_short = timed(*args, 128, True)
    h, kvh, d, dv = phi3
    b_ms, b_by = costs.decode_attention(DECODE_M, PREFILL_LONG, h, kvh, d, dv).bound_ms()
    s_ms, s_by = costs.decode_attention(DECODE_M, 129, h, kvh, d, dv).bound_ms()
    del args
    err = max(err, held(f"{LM_ARCH} float32", *caches(phi3, LM_SCORE_LEN, torch.float32), 1000, True))
    rec = dict(ms_index128=t_short["kernel"], plain_ms_index128=t_short["plain"],
               library_ms_index128=t_short["library"], bound_ms_index128=s_ms, bound_by_index128=s_by)
    for arch in (MOE_ARCH, "chatglm3-6b"):
        shape = attention_shape(arch)
        args = caches(shape, LM_SCORE_LEN, torch.bfloat16)
        for index in (0, LM_SCORE_LEN - 1):
            err = max(err, held(arch, *args, index, False))
        if arch == "chatglm3-6b":
            t = timed(*args, LM_SCORE_LEN - 1, False)
            c_ms, c_by = costs.decode_attention(DECODE_M, LM_SCORE_LEN, *shape).bound_ms()
            rec.update(ms_chatglm3_2048=t["kernel"], plain_ms_chatglm3_2048=t["plain"],
                       library_ms_chatglm3_2048=t["library"], bound_ms_chatglm3_2048=c_ms)
        del args
    # qwen3-moe's decode_32k layer: G 8 in the cache, the second mode
    shape = attention_shape(MOE_ARCH)
    args = caches(shape, PREFILL_LONG, torch.bfloat16)
    err = max(err, held(MOE_ARCH, *args, PREFILL_LONG - 1, False))
    t = timed(*args, PREFILL_LONG - 1, False)
    q_ms, q_by = costs.decode_attention(DECODE_M, PREFILL_LONG, *shape).bound_ms()
    rec.update(ms_qwen3_32k=t["kernel"], plain_ms_qwen3_32k=t["plain"], library_ms_qwen3_32k=t["library"],
               bound_ms_qwen3_32k=q_ms, bound_by_qwen3_32k=q_by)
    del args
    print(f"  decode_attention {LM_ARCH} {DECODE_M} x {PREFILL_LONG} keys x {phi3}: kernel {t_long['kernel']} ms, "
          f"plain {t_long['plain']} ms, SDPA {t_long['library']} ms, bound {b_ms} ms ({b_by}); {rec}")
    torch.cuda.empty_cache()
    return dict(source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/layers/attention.py:155-185 (jnp decode_attention_incremental), "
                         ":188-209 (jnp decode_attention)",
                max_abs_err=err, ms=t_long["kernel"], plain_ms=t_long["plain"], bound_ms=b_ms, bound_by=b_by,
                library_ms=t_long["library"], library_call=SDPA_NOTE,
                shape=f"{DECODE_M} x {PREFILL_LONG} keys x {phi3}", **rec)


def drive_binary_matmul(dev, cfg, gen) -> dict:
    """The public op through both kernel implementations at a prefill-sized
    activation and phi3's up projection; both must equal the ±1 oracle."""
    x = torch.randn((LM_SCORE_LEN, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((cfg.d_ff, cfg.d_model), generator=gen, device=dev)
    want = kops.binary_matmul(x, w, implementation="ref")
    zero_counts()
    packed = kops.binary_matmul(x, w, implementation="pallas_packed")
    mxu = kops.binary_matmul(x, w, implementation="pallas_mxu")
    launches = read_counts()
    same("binary_matmul pallas_packed == ref", packed, want)
    same("binary_matmul pallas_mxu == ref", mxu, want)
    for name in ("bnn_matmul_packed", "bnn_matmul_mxu", "bitpack"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"binary_matmul never launched {name}: {launches}")
    by_route = dict(bnn_matmul_mxu.bnn_matmul_mxu.launches_by_route)
    if by_route["tma"] != launches["bnn_matmul_mxu"]:
        raise AssertionError(f"binary_matmul's bnn_matmul_mxu launches by route: {by_route}")
    print(f"binary-GEMM op path: launches {launches}; bnn_matmul_mxu by route {by_route}")
    return launches


def packed_launches(cfg) -> tuple[int, int]:
    """(``bnn_matmul_packed``, ``bnn_matmul_packed_experts``) launches one
    attention block makes in a prefill or a decode step, each after one
    ``bitpack``: the packed GQA projections (q, k, v, o; MLA's are never
    packed), the packed FFN (SwiGLU 3, GELU 2) or an MoE layer's shared
    SwiGLU, and an MoE layer's three expert contractions.  (A Mamba2 layer
    is no attention block: ``attention_blocks`` counts none in an SSM.)"""
    targets = cfg.quant.targets if cfg.quant.packed else ()
    proj = 4 if cfg.attention == "gqa" and "attn_proj" in targets else 0
    experts = 0
    if cfg.family == "moe":
        experts = 3 if "moe" in targets else 0
        proj += 3 if cfg.moe.num_shared and "ffn" in targets else 0
    elif "ffn" in targets:
        proj += 3 if cfg.act == "swiglu" else 2
    return proj, experts


def attention_blocks(cfg) -> int:
    """Attention blocks one prefill, decode step or forward runs, each making
    ``packed_launches(cfg)`` packed launches (and, scoring with flash, one
    ``flash_attention``): every layer; none in an SSM; in the hybrid one
    application of the shared block per group of ``hybrid_period`` layers."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_period
    return cfg.num_layers


def call_launches(cfg) -> dict:
    """Each kernel's launches in one prefill, decode step or forward without
    flash (``packed_launches`` x ``attention_blocks``), zeros left out."""
    proj, experts = packed_launches(cfg)
    blocks = attention_blocks(cfg)
    per_call = {"bnn_matmul_packed": proj * blocks, "bnn_matmul_packed_experts": experts * blocks,
                "bitpack": (proj + experts) * blocks}
    return {name: n for name, n in per_call.items() if n}


def attention_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """The attention kernels' launches in ``prefills`` prefills and
    ``decode_steps`` decode steps, zeros left out: one ``chunked_attention``
    an attention block a prefill (GQA and MLA alike), one
    ``decode_attention`` an attention block a decode step of a GQA model
    (MLA's absorbed decode is plain; an SSM has no attention block)."""
    blocks = attention_blocks(cfg)
    per_run = {"chunked_attention": blocks * prefills,
               "decode_attention": blocks * decode_steps if cfg.attention == "gqa" else 0}
    return {name: n for name, n in per_run.items() if n}


def check_attention_launches(label: str, cfg, want: dict) -> None:
    """Fail unless the attention kernels' launches by route, mask and mode
    are all ``want``'s on the model's own: ``chunked_attention`` causal on
    the tma route in bf16 (f32 in float32), ``decode_attention`` on its
    type's route in the decode mode of ``cfg.decode_cache_carry``."""
    ca, de = chunked_kernel.chunked_attention, decode_kernel.decode_attention
    bf16 = cfg.param_dtype() == torch.bfloat16
    n = want.get("chunked_attention", 0)
    if (ca.launches_by_route != {"tma": n * bf16, "mma": 0, "f32": n * (not bf16)}
            or ca.launches_by_mask != {"causal": n, "full": 0}):
        raise AssertionError(f"{label}: chunked_attention by route {ca.launches_by_route}, by mask "
                             f"{ca.launches_by_mask}: expected all {n} causal on its type's route")
    n = want.get("decode_attention", 0)
    mode = "incremental" if cfg.decode_cache_carry else "in_cache"
    if (de.launches_by_mode != {"incremental": 0, "in_cache": 0, mode: n}
            or de.launches_by_route != {"bf16": n * bf16, "f32": n * (not bf16)}):
        raise AssertionError(f"{label}: decode_attention by mode {de.launches_by_mode}, by route "
                             f"{de.launches_by_route}: expected all {n} {mode} on its type's route")


def expected_routes(per_layer: int, cfg, decode_steps: int, sizes: list[int]) -> dict:
    """A kernel's launches by route over a serving run: ``per_layer``
    launches an attention block in each decode step (M or C of at most
    STREAM_MAX_M: ``stream``) and each prefill of ``sizes`` rows (``stream``
    up to STREAM_MAX_M, else ``mma``; ``tiled`` is never taken); every K
    here is a multiple of 128 bits."""
    short = sum(m <= bnn_matmul.STREAM_MAX_M for m in sizes)
    per_call = per_layer * attention_blocks(cfg)
    return {"stream": per_call * (decode_steps + short), "mma": per_call * (len(sizes) - short), "tiled": 0}


def check_serving_launches(label: str, cfg, launches: dict, calls: int, decode_steps: int,
                           sizes: list[int]) -> dict:
    """Fail unless a serving run's launches are exactly ``calls`` calls'
    (``call_launches``) and the attention kernels' of its ``len(sizes)``
    prefills and ``decode_steps`` steps (``attention_launches``, on the
    model's route and mode), each packed kernel's by route
    ``expected_routes``, and every ``bitpack`` launch bf16 on the vec route.
    Returns the routes."""
    attention = attention_launches(cfg, len(sizes), decode_steps)
    want = {name: n * calls for name, n in call_launches(cfg).items()} | attention
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want} ({call_launches(cfg)} a call "
                             f"x {calls} calls, and the attention kernels {attention}; "
                             f"{attention_blocks(cfg)} attention blocks a call)")
    check_attention_launches(label, cfg, attention)
    proj, experts = packed_launches(cfg)
    by_route = {}
    if proj:
        by_route["bnn_matmul_packed"] = expected_routes(proj, cfg, decode_steps, sizes)
    if experts:
        capacities = [capacity_of(s, cfg) for s in sizes]
        if capacity_of(DECODE_M, cfg) > bnn_matmul.STREAM_MAX_M:
            raise AssertionError(f"{label}: a decode step's capacity is past the stream route")
        by_route["bnn_matmul_packed_experts"] = expected_routes(experts, cfg, decode_steps, capacities)
    for name, want_routes in by_route.items():
        got = dict(COUNTED[name].launches_by_route)
        if got != want_routes:
            raise AssertionError(f"{label}: {name} launches by route {got}, expected {want_routes}")
    # Every bitpack launch, decode steps included, takes the bf16 activation
    # as it comes (no cast to float32) on the vec route.
    pack = bitpack.bitpack
    total = want.get("bitpack", 0)
    if pack.launches_by_dtype["bfloat16"] != total or pack.launches_by_route["vec"] != total:
        raise AssertionError(f"{label}: bitpack launches by type {pack.launches_by_dtype}, by route "
                             f"{pack.launches_by_route}: expected all {total} bf16 on the vec route")
    return by_route


@torch.inference_mode()
def drive_serving(dev, cfg, params, requests: int = LM_REQUESTS, label: str = LM_ARCH) -> dict:
    """The ``Engine`` serves ``requests`` prompts of 16 to 128 tokens, 32 new
    tokens each, at DECODE_M slots.  Every packed projection and expert
    contraction launches its kernel after one ``bitpack`` (bf16 input, vec
    route), exactly ``call_launches`` per call (``check_serving_launches``);
    every decode-step launch takes the stream route, a prefill's the route
    its rows pick."""
    rng = np.random.default_rng(SEED)
    eng = Engine(cfg, params, max_batch=DECODE_M, max_len=256, device=dev)
    lengths = [int(rng.integers(16, 129)) for _ in range(requests)]
    for i, s in enumerate(lengths):
        prompt = rng.integers(0, cfg.vocab_size, s).astype(np.int32)
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=LM_NEW_TOKENS))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    launches = read_counts()
    if sorted(r.rid for r in done) != list(range(requests)):
        raise AssertionError(f"{label}: served {sorted(r.rid for r in done)} of {requests} requests")
    for r in done:
        if len(r.output) != LM_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"{label} request {r.rid}: {len(r.output)} tokens, {r.output[:8]}...")
    calls = requests + eng.decode_steps  # prefills + batched decode steps
    by_route = check_serving_launches(label, cfg, launches, calls, eng.decode_steps, lengths)
    pack = bitpack.bitpack
    print(f"serving path ({label}, {cfg.num_layers} layers, {cfg.dtype}, {cfg.quant.mode} on "
          f"{cfg.quant.targets}): {requests} requests of {lengths} tokens, wall {wall} s; prefill "
          f"{eng.prefill_seconds} s for {requests} prompts; decode {eng.decode_seconds} s for "
          f"{eng.decode_steps} steps ({eng.decode_seconds / eng.decode_steps * 1e3} ms/step), "
          f"{eng.decode_tokens} tokens -> {eng.decode_tokens / eng.decode_seconds} decode tokens/s; "
          f"launches {launches}; by route {by_route}; bitpack by type {pack.launches_by_dtype}")
    print(f"  sample: request 0 -> {done[0].output[:8]}...")
    return launches


def lm_inputs(cfg, length: int, gen, dev) -> dict:
    """One sequence of ``length`` positions in ``cfg.input_mode``: tokens;
    ``num_patches`` seeded normal patch embeddings and the tokens after
    them; or seeded normal frames."""
    dtype = cfg.param_dtype()
    if cfg.input_mode == "frames":
        return {"frames": torch.randn((1, length, cfg.d_model), generator=gen, device=dev).to(dtype)}
    patches = cfg.num_patches if cfg.input_mode == "tokens+patches" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, length - patches), generator=gen, device=dev)}
    if patches:
        batch["patches"] = torch.randn((1, patches, cfg.d_model), generator=gen, device=dev).to(dtype)
    return batch


@torch.inference_mode()
def score(dev, cfg, params, gen, length: int = LM_SCORE_LEN, label: str = LM_ARCH) -> dict:
    """``forward`` with the flash kernel over one ``length``-position
    sequence (``lm_inputs``): finite logits of the right shape; exactly
    ``call_launches`` plus one ``flash_attention`` an attention block, every
    flash launch on the tma route, causal unless the model is encoder-only,
    and every packed contraction on the mma route."""
    flash_cfg = dataclasses.replace(cfg, attn_impl="pallas_flash")
    batch = lm_inputs(cfg, length, gen, dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    logits, aux = models.forward(params, batch, flash_cfg)
    finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    seconds = time.perf_counter() - t0
    launches = read_counts()
    blocks = attention_blocks(cfg)
    want = dict(call_launches(cfg), **({"flash_attention": blocks} if blocks else {}))
    if launches != want:
        raise AssertionError(f"{label} scoring: launches {launches}, expected {want}")
    fa = flash_attention.flash_attention
    by_route, by_mask = dict(fa.launches_by_route), dict(fa.launches_by_mask)
    mask = "full" if cfg.encoder_only else "causal"
    if by_route["tma"] != blocks or by_mask[mask] != blocks:
        raise AssertionError(f"{label}: flash_attention by route {by_route}, by mask {by_mask}: expected "
                             f"all {blocks} on the tma route, {mask}")
    proj, experts = packed_launches(cfg)
    for name, n in (("bnn_matmul_packed", proj), ("bnn_matmul_packed_experts", experts)):
        got = dict(COUNTED[name].launches_by_route)
        want_routes = {"stream": 0, "mma": n * blocks, "tiled": 0}
        if got != want_routes:
            raise AssertionError(f"{label} scoring: {name} launches by route {got}, expected {want_routes}")
    if logits.shape != (1, length, cfg.vocab_size) or not finite:
        raise AssertionError(f"{label}: scoring logits {tuple(logits.shape)}, finite={finite}")
    print(f"scoring path ({label}, forward, pallas_flash at D={cfg.resolved_head_dim}, 1 x {length} "
          f"positions {sorted(batch)}): {seconds} s, aux {float(aux)}, launches {launches}; "
          f"flash_attention by route {by_route}, by mask {by_mask}")
    return launches


@torch.inference_mode()
def drive_scoring(dev, cfg, params, gen) -> dict:
    """``forward`` with the flash kernel over one LM_SCORE_LEN-token sequence,
    then a 2-layer float32 unquantized copy: flash logits vs plain attention."""
    launches = score(dev, cfg, params, gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_SCORE_LEN), generator=gen, device=dev)
    small = dataclasses.replace(cfg, num_layers=2, dtype="float32", quant=QuantConfig())
    p2 = models.init_params(small, SEED + 1, device=dev)
    want, _ = models.forward(p2, {"tokens": tokens}, small)
    got, _ = models.forward(p2, {"tokens": tokens}, dataclasses.replace(small, attn_impl="pallas_flash"))
    close("2-layer float32 forward: flash logits vs plain attention", got, want, 2e-3)
    return launches


# ---------------------------------------------------------------------------
# The MoE and MLA models
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
MLA_ARCH = "deepseek-v2-236b"
MLA_LAYERS = 60        # deepseek-v2's published depth (about 48 GB resident)
SMALL_ARCHS = ("minicpm3-4b", "stablelm-3b", "chatglm3-6b")
SMALL_LAYERS = 4       # their new code is per layer: depth would add only time
SMALL_REQUESTS = 4
MOE_QUANT = QuantConfig(mode="bnn_packed", targets=("ffn", "attn_proj", "moe"))
EXPERT_C = (1, 10, 160)    # qwen3's capacity at a decode step of 4 slots, a 128-token prompt, 2048 tokens
EXPERT_GRAPH_LAYERS = 4    # qwen3 layers' expert weights per graph: 302 MB, beyond the 50 MB L2


def expert_shapes(cfg) -> list[tuple[int, int, int, int]]:
    """(E, O, Kw, k_bits) of an MoE layer's gate, up and down launches."""
    m = cfg.moe
    d, f = cfg.d_model, m.expert_ffn_dim
    return [(m.num_experts, f, d // 32, d)] * 2 + [(m.num_experts, d, f // 32, f)]


def random_words(shape, gen, dev) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32, generator=gen, device=dev)


def check_bnn_matmul_packed_experts(dev, gen) -> dict:
    """The batched packed expert GEMM bit for bit against its plain version:
    qwen3-moe-30b-a3b's and deepseek-v2-236b's gate and down shapes at C of
    1 (a decode step of 4 slots), 10 (a 128-token prompt) and 160 (qwen3's
    2048-token scoring pass: the second 128-row tile a quarter full), a
    ragged K (not a multiple of 32) on each route, and odd E; each case
    asserts its route, the mma ones also held on tiled, forced.  Timed per
    qwen3 decode layer (gate, up and down at C = 1) as the device time of a
    CUDA graph over EXPERT_GRAPH_LAYERS layers' distinct weights, in turns
    with the tiled route and with ``torch.bmm`` of pre-signed bf16 operands;
    the plain version beside it.  One scoring layer (C = 160) as graph
    replays in turns: mma, tiled (forced), ``torch.bmm`` of pre-signed bf16
    and ``torch._int_mm`` of +-1 int8 (a loop over the experts), beside the
    bound."""
    fn = bnn_matmul.bnn_matmul_packed_experts
    err = 0

    def held(label, x, w, k, path):
        nonlocal err
        want = ref.bnn_matmul_packed_experts_ref(x, w, k)
        err = max(err, same(f"{label} ({path})", routed(fn, path, lambda: fn(x, w, k_bits=k)), want))
        if path == "mma":
            out = torch.empty_like(want)
            err = max(err, same(f"{label} (tiled, forced)", routed(fn, "tiled", lambda: bnn_matmul._launch_experts(
                x, w, out, k, "tiled")), want))

    for arch in (MOE_ARCH, MLA_ARCH):
        for e, o, kw, k in expert_shapes(get_config(arch))[1:]:  # gate (= up) and down
            w = random_words((e, o, kw), gen, dev)
            for c in EXPERT_C:
                x = random_words((e, c, kw), gen, dev)
                path = "stream" if c <= bnn_matmul.STREAM_MAX_M else "mma"
                held(f"bnn_matmul_packed_experts {arch} E={e} C={c} O={o} Kw={kw}", x, w, k, path)
            del w
    # Packed from floats, so the bits past K are zero in both operands.
    for e, c, o, k, path in ((7, 10, 300, 1000, "stream"), (7, 10, 300, 3163, "mma"),
                             (5, 1, 129, 70, "mma"), (1, 160, 64, 2048, "mma"), (3, 160, 70, 513, "mma")):
        x = kops._pack_rows(torch.randn((e * c, k), generator=gen, device=dev)).view(e, c, -1)
        w = kops._pack_rows(torch.randn((e * o, k), generator=gen, device=dev)).view(e, o, -1)
        held(f"bnn_matmul_packed_experts E={e} C={c} O={o} K={k}", x, w, k, path)

    cfg = get_config(MOE_ARCH)
    shapes = expert_shapes(cfg)
    layers = [[random_words((e, o, kw), gen, dev) for e, o, kw, _ in shapes] for _ in range(EXPERT_GRAPH_LAYERS)]
    xs = [random_words((e, 1, kw), gen, dev) for e, _, kw, _ in shapes]
    outs = [torch.empty((e, 1, o), dtype=torch.int32, device=dev) for e, o, _, _ in shapes]
    for x, w in zip(xs, layers[0]):
        if bnn_matmul.experts_route(x, w) != "stream":
            raise AssertionError(f"decode expert shape {tuple(x.shape)} cannot take the stream route")

    def expert_layers(path, xs=xs, outs=outs, layers=layers):
        return lambda: [bnn_matmul._launch_experts(x, w, out, k, path) for layer in layers
                        for x, w, out, (_, _, _, k) in zip(xs, layer, outs, shapes)]

    signed_x = [ref.sign(torch.randn((e, 1, k), generator=gen, device=dev), torch.bfloat16)
                for e, _, _, k in shapes]
    signed_w = [[ref.sign(torch.randn((e, k, o), generator=gen, device=dev), torch.bfloat16)
                 for e, o, _, k in shapes] for _ in range(EXPERT_GRAPH_LAYERS)]
    library = lambda: [torch.bmm(x, w) for layer in signed_w for x, w in zip(signed_x, layer)]  # noqa: E731
    t = graphs_in_turns({"stream": expert_layers("stream"), "tiled": expert_layers("tiled"),
                         "torch.bmm": library})
    per_layer = {name: v / EXPERT_GRAPH_LAYERS for name, v in t.items()}
    del signed_x
    plain = time_ms(lambda: [ref.bnn_matmul_packed_experts_ref(x, w, k)
                             for x, w, (_, _, _, k) in zip(xs, layers[0], shapes)], iters=3)
    b_ms, b_by = costs.total(costs.bnn_matmul_packed_experts(e, 1, o, kw) for e, o, kw, _ in shapes).bound_ms()
    print(f"  bnn_matmul_packed_experts per {MOE_ARCH} decode layer (3 launches at C=1), graph replay: "
          f"stream {per_layer['stream']} ms, tiled {per_layer['tiled']} ms, torch.bmm bf16 "
          f"{per_layer['torch.bmm']} ms; bound {b_ms} ms ({b_by}); plain {plain} ms")

    # One scoring layer: C = 160 slots of every expert, one layer's weights.
    c_score = capacity_of(LM_SCORE_LEN, cfg)
    xs_score = [random_words((e, c_score, kw), gen, dev) for e, _, kw, _ in shapes]
    outs_score = [torch.empty((e, c_score, o), dtype=torch.int32, device=dev) for e, o, _, _ in shapes]
    sx = [ref.sign(torch.randn((e, c_score, k), generator=gen, device=dev), torch.bfloat16) for e, _, _, k in shapes]
    ix = [v.to(torch.int8) for v in sx]
    iw = [[wi.T.contiguous().T for wi in w.to(torch.int8)] for w in signed_w[0]]
    calls = {"mma": expert_layers("mma", xs_score, outs_score, layers[:1]),
             "tiled (forced)": expert_layers("tiled", xs_score, outs_score, layers[:1]),
             "torch.bmm bf16": lambda: [torch.bmm(x, w) for x, w in zip(sx, signed_w[0])],
             "torch._int_mm int8": lambda: [torch._int_mm(x[i], ws[i]) for x, ws in zip(ix, iw)
                                            for i in range(x.shape[0])]}
    score = graphs_in_turns(calls, iters=10)
    del signed_w, sx, ix, iw
    s_ms, s_by = costs.total(costs.bnn_matmul_packed_experts(e, c_score, o, kw)
                             for e, o, kw, _ in shapes).bound_ms()
    print(f"  bnn_matmul_packed_experts per scoring layer (C={c_score}, 3 launches), graph replay: "
          + ", ".join(f"{name} {v} ms" for name, v in score.items()) + f"; bound {s_ms} ms ({s_by})")
    return dict(source="src/repro_torch/csrc/bnn_matmul.cu",
                replaces="src/repro/layers/moe.py:104",
                max_abs_err=err, ms=per_layer["stream"], plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=per_layer["torch.bmm"], decode_ms_tiled_forced=per_layer["tiled"],
                scoring_layer_ms_mma=score["mma"], scoring_layer_ms_tiled_forced=score["tiled (forced)"],
                scoring_layer_library_ms_torch_bmm=score["torch.bmm bf16"],
                scoring_layer_ms_torch_int_mm=score["torch._int_mm int8"],
                scoring_layer_bound_ms=s_ms, scoring_layer_bound_by=s_by)


def init_model(cfg, label: str) -> dict:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(cfg, SEED, device=torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"{label}: init_params {time.perf_counter() - t0} s, {torch.cuda.memory_allocated() / 1e9} GB "
          f"resident (peak {torch.cuda.max_memory_allocated() / 1e9} GB)")
    return params


def free(params: dict) -> None:
    params.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def drive_moe_mla(dev, gen) -> tuple[dict, dict]:
    """The MoE/MLA phase (module docstring, step 10).  Returns each run's
    launches by path, and the expert kernel's by route in qwen3's serving
    run."""
    by_path = {}
    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH, quant=MOE_QUANT)
    print(f"{MOE_ARCH} at its published config: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{cfg.quant.mode} on {cfg.quant.targets}")
    params = init_model(cfg, MOE_ARCH)
    by_path["qwen3 serving"] = drive_serving(dev, cfg, params, LM_REQUESTS, MOE_ARCH)
    serving_routes = dict(bnn_matmul.bnn_matmul_packed_experts.launches_by_route)
    by_path["qwen3 scoring"] = score(dev, cfg, params, gen, label=MOE_ARCH)
    free(params)
    print(f"{MOE_ARCH} phase: {time.perf_counter() - t_phase} s")

    t_phase = time.perf_counter()
    cfg = get_config(MLA_ARCH, quant=MOE_QUANT, num_layers=MLA_LAYERS)
    print(f"{MLA_ARCH} at published widths: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, MLA kv_lora {cfg.mla.kv_lora_rank}, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.top_k} + {cfg.moe.num_shared} shared, {cfg.dtype}, {cfg.quant.mode}")
    params = init_model(cfg, MLA_ARCH)
    by_path["deepseek serving"] = drive_serving(dev, cfg, params, SMALL_REQUESTS, MLA_ARCH)
    free(params)
    print(f"{MLA_ARCH} phase: {time.perf_counter() - t_phase} s")

    for arch in SMALL_ARCHS:
        t_phase = time.perf_counter()
        cfg = get_config(arch, quant=MOE_QUANT, num_layers=SMALL_LAYERS)
        print(f"{arch} at published widths, {cfg.num_layers} layers, head dim {cfg.resolved_head_dim}, "
              f"attention {cfg.attention}, rotary share {cfg.rotary_pct}, decode carry "
              f"{cfg.decode_cache_carry}")
        params = init_model(cfg, arch)
        by_path[f"{arch} serving"] = drive_serving(dev, cfg, params, SMALL_REQUESTS, arch)
        if arch == "stablelm-3b":  # flash at D = 80 on the tma route
            by_path[f"{arch} scoring"] = score(dev, cfg, params, gen, label=arch)
        free(params)
        print(f"{arch} phase: {time.perf_counter() - t_phase} s")

    t_phase = time.perf_counter()
    for arch in ASSIGNED_ARCHS:
        argv = ["--arch", arch, "--reduced", "--device", "cuda"]
        if arch not in LAUNCH_REFUSES:
            serve_launch.main(argv)
            continue
        error, match = LAUNCH_REFUSES[arch]
        try:
            serve_launch.main(argv)
        except error as e:
            if match not in str(e):
                raise
            print(f"launch.serve --arch {arch}: refused as the reference's launcher is, {error.__name__}: {e}")
        else:
            raise AssertionError(f"launch.serve --arch {arch} served; the reference's launcher refuses it")
    print(f"launch.serve --reduced, {len(ASSIGNED_ARCHS)} archs: {time.perf_counter() - t_phase} s")
    return by_path, serving_routes


# ---------------------------------------------------------------------------
# The SSM, hybrid, VLM and audio models
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "zamba2-1.2b"
VLM_ARCH = "internvl2-2b"
AUDIO_ARCH = "hubert-xlarge"
# The reference's launcher fails on these two: hubert is encoder-only (the
# Engine refuses it) and the Engine prefills tokens without internvl2's patches.
LAUNCH_REFUSES = {AUDIO_ARCH: (ValueError, "encoder-only"), VLM_ARCH: (KeyError, "patches")}
CPU_CHECK_LEN = 32   # positions of the card-vs-CPU check (a VLM's patches come on top)


@torch.inference_mode()
def check_against_cpu(dev, cfg, label: str) -> float:
    """The family's path on the card against the port's plain path on the
    CPU (which the CPU tests hold against the reference): a float32
    unquantized copy at published widths with 2 layers (the hybrid one group
    and a one-layer tail), weights and inputs made on the CPU from a seed;
    on the card its attention runs flash (the f32 route, causal or full as
    the model is).  Logits within 2e-3, as ``drive_scoring`` holds flash
    against plain attention."""
    layers = cfg.hybrid_period + 1 if cfg.family == "hybrid" else 2
    small = dataclasses.replace(cfg, num_layers=layers, dtype="float32", quant=QuantConfig())
    params = models.init_params(small, SEED + 1, device="cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    length = CPU_CHECK_LEN + (small.num_patches if small.input_mode == "tokens+patches" else 0)
    batch = lm_inputs(small, length, gen, "cpu")
    want, _ = models.forward(params, batch, small)
    got, _ = models.forward(tree.map(lambda t: t.to(dev), params), {k: v.to(dev) for k, v in batch.items()},
                            dataclasses.replace(small, attn_impl="pallas_flash"))
    return close(f"{label}: {layers}-layer float32 forward, card (flash) vs CPU (plain)", got.cpu(), want, 2e-3)


PACKED_MS = ((DECODE_M, "stream"), (384, "mma"), (LM_SCORE_LEN, "mma"))  # decode, prompt, scoring


def check_packed_shapes(dev, cfg, gen, label: str) -> int:
    """``bitpack`` (bf16, vec route, planted subnormal signs) and
    ``bnn_matmul_packed`` bit for bit against their plain versions at each
    distinct (K, N) of the model's attention-block projections
    (``lm_projections``) and each M of PACKED_MS on its route."""
    fn, bp = bnn_matmul.bnn_matmul_packed, bitpack.bitpack
    cpu_gen = torch.Generator().manual_seed(SEED)
    err = 0
    for k, n in sorted({(k, n) for k, n, _ in lm_projections(cfg)}):
        wp, _ = kops.pack_weights(torch.randn((n, k), generator=gen, device=dev))
        for m, path in PACKED_MS:
            x = planted((m, k), torch.bfloat16, cpu_gen, dev)
            xp = routed(bp, "vec", lambda: bp(x))
            err = max(err, same(f"{label}: bitpack bf16 ({m}, {k}) (vec)", xp, bitpack.pack_ge_plain(x, 0)))
            err = max(err, same(f"{label}: bnn_matmul_packed M={m} K={k} N={n} ({path})",
                                routed(fn, path, lambda: fn(xp, wp, k_bits=k)),
                                ref.bnn_matmul_packed_ref(xp, wp, k)))
    return err


@torch.inference_mode()
def drive_vlm_decode(dev, cfg, params, gen, label: str = VLM_ARCH) -> dict:
    """What the ``Engine`` would do for a VLM, by hand: ``prefill`` of
    DECODE_M prompts, each ``num_patches`` seeded normal patch embeddings and
    16 to 128 tokens, each installed in its slot of one cache (zero-padded,
    the index the longest prompt's); then LM_NEW_TOKENS batched
    ``decode_step``s from position ``num_patches + S`` (the longest
    prompt's).  Launches exactly ``call_launches`` a call, decode-step GEMMs
    on the stream route."""
    rng = np.random.default_rng(SEED)
    lengths = [int(rng.integers(16, 129)) for _ in range(DECODE_M)]
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s))).to(dev) for s in lengths]
    patches = [torch.randn((1, cfg.num_patches, cfg.d_model), generator=gen, device=dev).to(cfg.param_dtype())
               for _ in lengths]
    cache = models.init_cache(cfg, DECODE_M, cfg.num_patches + max(lengths) + LM_NEW_TOKENS + 1, device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    last = []
    for slot, (tokens, p) in enumerate(zip(prompts, patches)):
        logits, pcache = models.prefill(params, {"tokens": tokens, "patches": p}, cfg)
        for dst, src in zip(cache_tensors(cache), cache_tensors(pcache)):
            dst[:, slot].zero_()
            dst[:, slot, : src.shape[2]] = src[:, 0]
        last.append(logits.argmax(-1))
    cache = set_index(cache, cfg.num_patches + max(lengths))
    token = torch.cat(last)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = [token]
    t0 = time.perf_counter()
    for _ in range(LM_NEW_TOKENS):
        logits, cache = models.decode_step(params, token, cache, cfg)
        token = logits.argmax(-1)
        out.append(token)
    tokens_out = torch.stack(out, 1).cpu()
    decode_s = time.perf_counter() - t0
    launches = read_counts()
    steps = LM_NEW_TOKENS
    by_route = check_serving_launches(label, cfg, launches, DECODE_M + steps, steps,
                                      [cfg.num_patches + s for s in lengths])
    if not (bool(torch.isfinite(logits).all()) and 0 <= int(tokens_out.min())
            and int(tokens_out.max()) < cfg.vocab_size):
        raise AssertionError(f"{label}: decode logits finite={bool(torch.isfinite(logits).all())}, tokens "
                             f"{tokens_out[:, :8].tolist()}")
    print(f"VLM decode path ({label}, {cfg.num_layers} layers, {cfg.dtype}, {cfg.quant.mode}, decode carry "
          f"{cfg.decode_cache_carry}): {DECODE_M} prompts of {cfg.num_patches} patches + {lengths} tokens, "
          f"prefill {prefill_s} s; decode {decode_s} s for {steps} steps ({decode_s / steps * 1e3} ms/step), "
          f"{DECODE_M * steps / decode_s} decode tokens/s; launches {launches}; by route {by_route}")
    print(f"  sample: slot 0 -> {tokens_out[0, :8].tolist()}...")
    return launches


def drive_ssm_families(dev, gen) -> dict:
    """The SSM / hybrid / VLM / audio phase (module docstring, step 11).
    Returns each run's launches by path."""
    by_path = {}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        t_phase = time.perf_counter()
        cfg = get_config(arch, quant=MOE_QUANT)
        print(f"{arch} at its published config: {cfg.num_layers} layers, d_model {cfg.d_model}, SSM state "
              f"{cfg.ssm.state_dim}, {cfg.ssm.num_ssm_heads(cfg.d_model)} SSM heads of {cfg.ssm.head_dim}, "
              f"chunk {cfg.ssm.chunk}, hybrid period {cfg.hybrid_period} ({attention_blocks(cfg)} shared-block "
              f"applications a call), vocab {cfg.vocab_size}, {cfg.dtype}, {cfg.quant.mode} on "
              f"{cfg.quant.targets}")
        check_against_cpu(dev, cfg, arch)
        if attention_blocks(cfg):
            check_packed_shapes(dev, cfg, gen, arch)
        params = init_model(cfg, arch)
        short = arch.split("-")[0]
        by_path[f"{short} serving"] = drive_serving(dev, cfg, params, LM_REQUESTS, arch)
        by_path[f"{short} scoring"] = score(dev, cfg, params, gen, label=arch)
        free(params)
        print(f"{arch} phase: {time.perf_counter() - t_phase} s")

    t_phase = time.perf_counter()
    cfg = get_config(VLM_ARCH, quant=MOE_QUANT)
    print(f"{VLM_ARCH} at its published config: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads ({cfg.num_kv_heads} KV) of {cfg.resolved_head_dim}, {cfg.num_patches} "
          f"patches, vocab {cfg.vocab_size}, {cfg.dtype}, {cfg.quant.mode}")
    check_against_cpu(dev, cfg, VLM_ARCH)
    check_packed_shapes(dev, cfg, gen, VLM_ARCH)
    params = init_model(cfg, VLM_ARCH)
    by_path["internvl2 decode"] = drive_vlm_decode(dev, cfg, params, gen)
    by_path["internvl2 scoring"] = score(dev, cfg, params, gen, label=VLM_ARCH)
    free(params)
    print(f"{VLM_ARCH} phase: {time.perf_counter() - t_phase} s")

    t_phase = time.perf_counter()
    cfg = get_config(AUDIO_ARCH, quant=MOE_QUANT)
    print(f"{AUDIO_ARCH} at its published config: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.resolved_head_dim}, encoder-only, {cfg.act} FFN, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, {cfg.quant.mode}")
    check_against_cpu(dev, cfg, AUDIO_ARCH)
    check_packed_shapes(dev, cfg, gen, AUDIO_ARCH)
    params = init_model(cfg, AUDIO_ARCH)
    by_path["hubert scoring"] = score(dev, cfg, params, gen, label=AUDIO_ARCH)
    free(params)
    print(f"{AUDIO_ARCH} phase: {time.perf_counter() - t_phase} s")
    return by_path


# ---------------------------------------------------------------------------
# Training the LMs
# ---------------------------------------------------------------------------

# launch/train.py's defaults (--batch 8 --seq 128) and --quant bnn_weight_only
# (latent weights of ``ffn`` and ``attn_proj`` binarized with STE).
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_QUANT = QuantConfig(mode="bnn_weight_only")
TRAIN_TIMED_STEPS = 4
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 64   # the 2-layer float32 copy held against the CPU
TRAINER_STEPS = 30
TRAINER_FAILURE = 15                     # restores step 10's checkpoint
TRAINER_SHORT_STEPS = 4
TRAINER_SHORT_ARCHS = ("qwen3-moe-30b-a3b", "minicpm3-4b")   # the MoE aux loss, MLA


def train_steps(params, state, step, data, dev, steps: int, label: str) -> tuple:
    """``steps`` calls of ``step`` on ``data``'s batches, each timed on the
    host clock to its metrics' ``float()`` (which waits for the card).
    Returns (params, state, [(seconds, metrics)])."""
    out = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.next_batch().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        out.append((time.perf_counter() - t0, metrics))
        print(f"  {label} step {int(state.step)}: loss {metrics['loss']} grad_norm {metrics['grad_norm']} "
              f"{out[-1][0]} s")
    return params, state, out


def check_training_against_cpu(dev, cfg) -> float:
    """One ``make_train_step`` step of a 2-layer float32 copy of ``cfg`` at
    published widths on the card against the CPU (weights and a
    TRAIN_CPU_BATCH x TRAIN_CPU_SEQ batch from a seed): loss and grad norm
    within 2e-3 of their size, every updated parameter within 2e-3 (AdamW
    moves an element by about lr = 1e-3 whatever its gradient's size, so a
    gradient that rounds to the other sign moves it up to 2e-3 the other
    way); prints how many elements differ by more than 1e-6 and fails if
    more than 1e-4 of them do."""
    small = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params = models.init_params(small, SEED + 2, device="cpu")
    batch = SyntheticTokens(small, global_batch=TRAIN_CPU_BATCH, seq_len=TRAIN_CPU_SEQ, seed=SEED + 2).next_batch()
    opt = AdamW(lr=1e-3)
    step = make_train_step(small, opt)
    on_card = tree.map(lambda t: t.to(dev, copy=True), params)
    got_p, _, got = step(on_card, opt.init(on_card), {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    want_p, _, want = step(params, opt.init(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        g, w = float(got[key]), float(want[key])
        if not abs(g - w) <= 2e-3 * max(1.0, abs(w)):
            raise AssertionError(f"2-layer float32 train step: {key} {g} on the card, {w} on the CPU")
    worst, apart, total = 0.0, 0, 0
    for g, w in zip(tree.leaves(got_p), tree.leaves(want_p), strict=True):
        diff = (g.cpu() - w).abs()
        worst = max(worst, float(diff.max()))
        apart += int((diff > 1e-6).sum())
        total += w.numel()
    if not (worst <= 2e-3 and apart <= 1e-4 * total):
        raise AssertionError(f"2-layer float32 train step: parameters apart by up to {worst} (limit 2e-3), "
                             f"{apart} of {total} by more than 1e-6")
    print(f"  2-layer float32 train step, card vs CPU ({TRAIN_CPU_BATCH} x {TRAIN_CPU_SEQ} tokens): loss "
          f"{float(got['loss'])} vs {float(want['loss'])}, grad_norm {float(got['grad_norm'])} vs "
          f"{float(want['grad_norm'])}; parameters within {worst}, {apart} of {total} elements apart by "
          f"more than 1e-6")
    return worst


def drive_training(dev) -> dict:
    """The training phase (module docstring, step 12).  Returns each run's
    launches by path (none may launch a kernel)."""
    by_path = {}
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH, quant=TRAIN_QUANT)
    print(f"{LM_ARCH} training at published widths: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, {cfg.quant.mode} on {cfg.quant.targets}, remat {cfg.remat}, "
          f"attention {cfg.attn_impl}; AdamW(lr=1e-3) with a float32 master, microbatches 1, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}")
    params = init_model(cfg, LM_ARCH)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    n_params = sum(t.numel() for t in tree.leaves(params))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 1e9
    print(f"  {n_params} parameters; params + AdamW state {resident} GB resident")
    before = [(t.flatten()[:4096].clone(), m.flatten()[:4096].clone())
              for t, m in zip(tree.leaves(params), tree.leaves(state.master))]
    data = SyntheticTokens(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED)
    step = make_train_step(cfg, opt, microbatches=1)
    zero_counts()
    params, state, runs = train_steps(params, state, step, data, dev, 1 + TRAIN_TIMED_STEPS, "phi3")
    by_path["phi3 training"] = read_counts()
    if by_path["phi3 training"]:
        raise AssertionError(f"phi3 training launched kernels: {by_path['phi3 training']}")
    for _, metrics in runs:
        if not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0):
            raise AssertionError(f"phi3 training: loss {metrics['loss']}, grad_norm {metrics['grad_norm']}")
    masters_moved = sum(not torch.equal(m0, m.flatten()[:4096]) for (_, m0), m in zip(before, tree.leaves(state.master)))
    params_moved = sum(int((p0 != p.flatten()[:4096]).sum()) for (p0, _), p in zip(before, tree.leaves(params)))
    if masters_moved != len(before) or not params_moved:
        raise AssertionError(f"phi3 training: {masters_moved} of {len(before)} master leaves moved, "
                             f"{params_moved} bf16 parameter elements")
    timed = [dt for dt, _ in runs[1:]]
    s_step = sum(timed) / len(timed)
    print(f"phi3 training ({cfg.num_layers} layers, {n_params} parameters): warm-up step {runs[0][0]} s; "
          f"{s_step} s/step over {len(timed)} steps ({min(timed)} to {max(timed)}), "
          f"{TRAIN_BATCH * TRAIN_SEQ / s_step} tokens/s; {torch.cuda.memory_allocated() / 1e9} GB resident, "
          f"peak {torch.cuda.max_memory_allocated() / 1e9} GB; {masters_moved} of {len(before)} master leaves "
          f"and {params_moved} sampled bf16 parameter elements moved; launches {by_path['phi3 training']}")
    del state, before
    free(params)
    check_training_against_cpu(dev, cfg)
    print(f"{LM_ARCH} training phase: {time.perf_counter() - t_phase} s")

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        argv = ["--arch", LM_ARCH, "--reduced", "--device", "cuda", "--steps", str(TRAINER_STEPS),
                "--microbatches", "2", "--compression", "sign", "--inject-failure", str(TRAINER_FAILURE),
                "--ckpt-dir", os.path.join(ckpt_dir, "phi3")]
        zero_counts()
        out = train_launch.main(argv)
        launches = read_counts()
        losses = [(h["step"], h["loss"]) for h in out["history"] if "loss" in h]
        print(f"launch.train {' '.join(argv[:-2])}: final step {out['final_step']}, recoveries "
              f"{out['recoveries']}, stragglers {len(out['stragglers'])}, loss by step {losses}; launches {launches}")
        if not (out["final_step"] == TRAINER_STEPS and out["recoveries"] == 1 and losses[-1][1] < losses[0][1]
                and all(np.isfinite([l for _, l in losses]))):
            raise AssertionError(f"launch.train --reduced {LM_ARCH}: {out}")
        for arch in TRAINER_SHORT_ARCHS:
            argv = ["--arch", arch, "--reduced", "--device", "cuda", "--steps", str(TRAINER_SHORT_STEPS),
                    "--ckpt-dir", os.path.join(ckpt_dir, arch)]
            out = train_launch.main(argv)
            losses = [(h["step"], h["loss"], h["aux"]) for h in out["history"] if "loss" in h]
            print(f"launch.train {' '.join(argv[:-2])}: final step {out['final_step']}, (step, loss, aux) {losses}")
            if not (out["final_step"] == TRAINER_SHORT_STEPS and all(np.isfinite([l for _, l, _ in losses]))):
                raise AssertionError(f"launch.train --reduced {arch}: {out}")
        by_path["launch.train --reduced"] = read_counts()
        if by_path["launch.train --reduced"]:
            raise AssertionError(f"launch.train launched kernels: {by_path['launch.train --reduced']}")
    print(f"launch.train --reduced phase: {time.perf_counter() - t_phase} s")
    return by_path


DRYRUN_QUANT = QuantConfig(mode="bnn_packed", targets=("ffn", "attn_proj"))   # hillclimb C1 and C2
DRYRUN_LAYERS = 4   # the depth of the two slow cells here (the sweep runs them whole)
# (arch, shape, config overrides, cell tag, timed steps): each at the batch
# its batch-1 measurement gives it (``dryrun.choose_batch``).  A step's
# time grows with depth x batch: at full depth phi3's prefill_32k takes
# 34 s a step and hubert's train_4k 79 s at batch 64, so those two run at
# DRYRUN_LAYERS layers.
DRYRUN_CELLS = (
    (LM_ARCH, "decode_32k", {"quant": DRYRUN_QUANT}, "+bnnpacked", 2),
    (LM_ARCH, "prefill_32k", {"quant": DRYRUN_QUANT, "num_layers": DRYRUN_LAYERS}, f"+bnnpacked-{DRYRUN_LAYERS}L", 1),
    (HYBRID_ARCH, "long_500k", {}, "", 2),
    (AUDIO_ARCH, "train_4k", {"num_layers": DRYRUN_LAYERS}, f"-{DRYRUN_LAYERS}L", 1),
)
# The route every packed GEMM of a packed cell takes: a decode step's M is
# its batch (<= 16), a prefill's M its batch x 32768 tokens.
DRYRUN_GEMM_ROUTE = {"decode": "stream", "prefill": "mma"}
# The attention kernel a cell of a model with attention launches (the
# decode cells start from a filled cache, with no prefill); training runs
# the plain paths.
ATTENTION_KERNELS = ("chunked_attention", "decode_attention")
DRYRUN_ATTENTION = {"decode": "decode_attention", "prefill": "chunked_attention", "train": None}
HELD_ROWS = 8192   # rows a chunk of the prefill-size plain versions


def signs(words: torch.Tensor, k: int) -> torch.Tensor:
    """(R, Kw) packed sign words -> (R, k) float32 +-1 (bit 1 is +1)."""
    bits = bitops.unpack_bits(bitops.i32_to_u32(words), count=k)
    return bits.to(torch.float32).mul_(2).sub_(1)


def check_prefill_shapes(dev, cfg, gen, m: int) -> tuple[int, dict]:
    """``bitpack`` (bf16, vec) and ``bnn_matmul_packed`` (mma) at a
    prefill's M = ``m`` rows of each of the model's distinct (K, N), every
    row held bit for bit against the plain versions, in chunks of HELD_ROWS
    rows: the bit-pack against ``pack_ge_plain``, the GEMM against a float32
    product of the unpacked +-1 operands (exact: every partial sum is an
    integer below 2^24).  Each GEMM is timed there with events in turns
    with tiled (forced), ``torch.matmul`` of pre-signed bf16 and
    ``torch._int_mm`` of +-1 int8, beside its bound.  Returns the max error
    and ``{(K, N): {name: ms, ..., "bound": ms}}``."""
    fn, bp = bnn_matmul.bnn_matmul_packed, bitpack.bitpack
    err, times = 0, {}
    for k, n in sorted({(k, n) for k, n, _ in lm_projections(cfg)}):
        wp, _ = kops.pack_weights(torch.randn((n, k), generator=gen, device=dev))
        x = torch.randn((m, k), generator=gen, device=dev)
        x[0, 3:3 + len(PLANTED)] = torch.tensor(PLANTED, device=dev)
        x[-1, ::3] = -1e-39
        x = x.to(torch.bfloat16)
        xp = routed(bp, "vec", lambda: bp(x))
        out = routed(fn, "mma", lambda: fn(xp, wp, k_bits=k))
        w = signs(wp, k)
        for r0 in range(0, m, HELD_ROWS):
            rows = slice(r0, r0 + HELD_ROWS)
            want_p = bitpack.pack_ge_plain(x[rows], 0)
            if not torch.equal(xp[rows], want_p):
                raise AssertionError(f"{LM_ARCH}: bitpack bf16 ({m}, {k}) (vec) disagrees with plain at rows "
                                     f"{rows.start}:{rows.stop}")
            want = (signs(xp[rows], k) @ w.T).to(torch.int32)
            diff = int((out[rows] - want).abs().max().item())
            if diff:
                raise AssertionError(f"{LM_ARCH}: bnn_matmul_packed M={m} K={k} N={n} (mma) disagrees with "
                                     f"plain at rows {rows.start}:{rows.stop} (max diff {diff})")
            err = max(err, diff)
        del x, w
        xs, ws = ref.sign(torch.randn((m, k), generator=gen, device=dev), torch.bfloat16), ref.sign(
            torch.randn((k, n), generator=gen, device=dev), torch.bfloat16)
        xi, wi = xs.to(torch.int8), ws.T.contiguous().T.to(torch.int8)  # (K, N) column-major for _int_mm
        t = in_turns({"mma": lambda: bnn_matmul._launch(xp, wp, out, k, "mma"),
                      "tiled (forced)": lambda: bnn_matmul._launch(xp, wp, out, k, "tiled"),
                      "torch.matmul bf16": lambda: torch.matmul(xs, ws),
                      "torch._int_mm int8": lambda: torch._int_mm(xi, wi)}, f"M={m} K={k} N={n}", iters=3)
        b_ms, b_by = costs.bnn_matmul_packed(m, n, wp.shape[1]).bound_ms()
        times[(k, n)] = dict(t, bound=b_ms)
        print(f"  {LM_ARCH}: bitpack bf16 ({m}, {k}) (vec) and bnn_matmul_packed M={m} K={k} N={n} (mma, tile "
              f"width {bnn_matmul.mma_block_n(m, n, 1, bnn_matmul._sm_count(xp.device))}): every row bit-exact; "
              + ", ".join(f"{name} {v} ms" for name, v in t.items()) + f" (events, in turns); bound {b_ms} ms ({b_by})")
        del xp, out, xs, ws, xi, wi
        torch.cuda.empty_cache()
    return err, times


def drive_dryrun(dev, gen) -> tuple[dict, dict]:
    """The dry-run phase (module docstring, step 13).  Returns each cell's
    launches by path, and the prefill GEMM's times at the cell's M
    (``check_prefill_shapes``)."""
    by_path, prefill_m = {}, []
    with tempfile.TemporaryDirectory() as out:
        for arch, shape_name, overrides, tag, steps in DRYRUN_CELLS:
            t_cell = time.perf_counter()
            torch.cuda.empty_cache()
            zero_counts()
            rec = dryrun.run_cell(arch, shape_name, out, overrides, tag, device=dev, steps=steps)
            launches = read_counts()
            routes = dict(bnn_matmul.bnn_matmul_packed.launches_by_route)
            label = f"dry run {arch}{tag} {shape_name}"
            by_path[label] = launches
            if rec["status"] != "ok":
                raise AssertionError(f"{label}: {rec}")
            print(f"  {dryrun.summary_line(rec)} measure={rec['measure_s']}s "
                  f"counted-step={rec['count_s']}s launches={rec['launches']}")
            r = rec["roofline"]
            if not (rec["output"]["finite"] and 0 < r["roofline_fraction"] <= 1 and 0 < r["mfu"] <= 1):
                raise AssertionError(f"{label}: output {rec['output']}, roofline fraction "
                                     f"{r['roofline_fraction']}, mfu {r['mfu']}")
            if rec["launches"] != rec["counts"]["kernel_launches"]:
                raise AssertionError(f"{label}: the counted step launched {rec['launches']}, the count saw "
                                     f"{rec['counts']['kernel_launches']}")
            kind = dryrun_shapes.SHAPES[shape_name].kind
            cell_cfg = get_config(arch, **overrides)
            attention = {name: launches.get(name, 0) for name in ATTENTION_KERNELS}
            want = DRYRUN_ATTENTION[kind] if attention_blocks(cell_cfg) else None
            if {name: n > 0 for name, n in attention.items()} != {name: name == want for name in ATTENTION_KERNELS}:
                raise AssertionError(f"{label}: attention launches {attention}, expected only {want}")
            chunked_routes = dict(chunked_kernel.chunked_attention.launches_by_route)
            if chunked_routes["tma"] != attention["chunked_attention"]:
                raise AssertionError(f"{label}: chunked_attention by route {chunked_routes}: expected all tma")
            if "quant" in overrides:
                route = DRYRUN_GEMM_ROUTE[kind]
                if not (launches.get("bitpack") and launches.get("bnn_matmul_packed")
                        and routes[route] == launches["bnn_matmul_packed"]):
                    raise AssertionError(f"{label}: launches {launches}, GEMM routes {routes} (want all {route})")
                if kind == "prefill":
                    prefill_m.append(rec["batch"] * rec["seq_len"])
            elif set(launches) - set(ATTENTION_KERNELS):
                raise AssertionError(f"{label}: launched packed kernels at quant none: {launches}")
            counts = rec["counts"]
            print(f"  {label}: batch {rec['batch']}, counted step: kernel launches {counts['kernel_launches']}, "
                  f"kernel bytes {counts['kernel_bytes']}, kernel seconds {counts['kernel_seconds']}, aten bytes "
                  f"{counts['aten_bytes']}, top ops by bytes {counts['top_ops_by_bytes'][:4]}")
            print(f"  {label}: {time.perf_counter() - t_cell} s, launches {launches}, GEMM routes {routes}")
    times = {}
    for m in prefill_m:
        t0 = time.perf_counter()
        err, times[m] = check_prefill_shapes(dev, get_config(LM_ARCH, quant=DRYRUN_QUANT), gen, m)
        print(f"  the packed kernels at the prefill cell's M = {m} held against plain (max |err| {err}): "
              f"{time.perf_counter() - t0} s")
    return by_path, times


# The keys every entry of the kernels line has, in this order; a record's
# other numbers follow them.
CONTRACT_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(card_line())
    build_kernels()

    params = bnn.init_params(HEADLINE, torch.Generator().manual_seed(SEED))
    prog = compiler.compile_bnn([w.numpy() for w in params], RMT)
    lp = prog.lower()
    five = bnn.init_params(FIVE_TUPLE, torch.Generator().manual_seed(SEED + 1))
    five_prog = compiler.compile_bnn([w.numpy() for w in five], RMT)
    print(lp.summary())
    first = traffic.generate(SCENARIO, CHUNK, HEADLINE.input_bits, seed=SEED)
    pkt = torch.from_numpy(first).to(dev)
    # The packed backend packs each layer's input: (CHUNK, 32), then (CHUNK, 64).
    layer_inputs = (pkt, bnn.layer_forward(pkt, params[0].to(dev)))

    print("kernel vs plain PyTorch, on the card:")
    programs = {
        "HEADLINE/rmt": (lp, pkt),
        "HEADLINE/rmt+popcnt32": (
            compiler.compile_bnn([w.numpy() for w in params], RMT_NATIVE_POPCNT).lower(), pkt),
        "FIVE_TUPLE/rmt": (
            five_prog.lower(),
            torch.from_numpy(traffic.generate(SCENARIO, CHUNK, FIVE_TUPLE.input_bits, seed=SEED)).to(dev)),
    }
    records = {
        "optable_run": check_optable(dev, programs),
        "pack_bits_words": check_bitpack(dev, layer_inputs),
        "packed_layer": check_packed_layer(dev, lp, layer_inputs, programs["FIVE_TUPLE/rmt"]),
    }
    unrolled = executor.execute(lp, first, backend="packed", device=dev)
    if not np.array_equal(executor.execute(lp, first, backend="packed", scan_hops=True, device=dev), unrolled):
        raise AssertionError("packed scan-over-layers plan disagrees with the unrolled plan")

    results = drive_main_path(dev, lp, records)
    for backend, sr in results.items():
        print(probe_line(roofline.probe_stream(lp, backend=backend, chunk=CHUNK), sr.packets_per_second))
    opt, packed = results["jnp"].outputs, results["packed"].outputs
    if opt.shape != (PACKETS, HEADLINE.output_bits) or opt.max() > 1:
        raise AssertionError(f"unexpected output {opt.shape}, max {opt.max()}")
    if not np.array_equal(opt, packed):
        bad = int((opt != packed).any(axis=1).sum())
        raise AssertionError(f"op-table and packed backends disagree on {bad} packets")
    witness = interpreter.run_program(prog, first, device=dev).cpu().numpy()
    oracle = bnn.forward([p.to(dev) for p in params], pkt).cpu().numpy()
    if not (np.array_equal(opt[:CHUNK], witness) and np.array_equal(witness, oracle)):
        raise AssertionError("first chunk disagrees with run_program or the BNN oracle")
    print(f"both backends agree on all {PACKETS} packets; first chunk == run_program == bnn.forward")

    t_phase = time.perf_counter()
    drive_fabric(dev, five_prog, five, records)
    print(f"fabric phase: {time.perf_counter() - t_phase} s")
    t_phase = time.perf_counter()
    drive_fleet(dev, prog, lp, params, records)
    print(f"fleet phase: {time.perf_counter() - t_phase} s")
    t_phase = time.perf_counter()
    drive_train_deploy(dev, records)
    print(f"train -> deploy phase: {time.perf_counter() - t_phase} s")
    t_phase = time.perf_counter()
    drive_multitenant(dev, records)
    print(f"multi-tenant phase: {time.perf_counter() - t_phase} s")
    for name in ("optable_run", "pack_bits_words", "packed_layer", "packed_layer_routed"):
        records[name]["launches"] = sum(records[name]["launches_by_path"].values())

    t_lm = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32 (the default)
    cfg = get_config(LM_ARCH, quant=QuantConfig(mode="bnn_packed", targets=("ffn", "attn_proj")),
                     attn_impl="xla")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print(f"LM slice: {LM_ARCH} at published widths, {cfg.num_layers} layers, {cfg.dtype}, "
          f"quant {cfg.quant.mode} on {cfg.quant.targets}")
    print("kernel vs plain PyTorch, on the card:")
    records["bnn_matmul_packed"] = check_bnn_matmul_packed(dev, cfg, gen)
    records["bnn_matmul_mxu"] = check_bnn_matmul_mxu(dev, cfg, gen)
    records["flash_attention"] = check_flash(dev, cfg, gen)
    records["chunked_attention"] = check_chunked(dev, gen)
    records["decode_attention"] = check_decode(dev, gen)
    records["bnn_matmul_mxu"]["launches"] = drive_binary_matmul(dev, cfg, gen)["bnn_matmul_mxu"]
    t0 = time.perf_counter()
    lm_params = models.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    print(f"init_params: {time.perf_counter() - t0} s")
    lm_paths = {"phi3 serving": drive_serving(dev, cfg, lm_params)}
    serving_routes = dict(bnn_matmul.bnn_matmul_packed.launches_by_route)
    attention_routes = {name: dict(COUNTED[name].launches_by_route) for name in ATTENTION_KERNELS}
    lm_paths["phi3 scoring"] = drive_scoring(dev, cfg, lm_params, gen)
    records["bnn_matmul_packed"]["launches"] = lm_paths["phi3 serving"]["bnn_matmul_packed"]
    records["bnn_matmul_packed"]["launches_by_route"] = serving_routes
    records["flash_attention"]["launches"] = lm_paths["phi3 scoring"]["flash_attention"]
    for name in ATTENTION_KERNELS:
        records[name]["launches"] = lm_paths["phi3 serving"][name]
        records[name]["launches_by_route"] = attention_routes[name]
    free(lm_params)
    print(f"LM phases: {time.perf_counter() - t_lm} s")

    t_moe = time.perf_counter()
    print("MoE / MLA phase; kernel vs plain PyTorch, on the card:")
    records["bnn_matmul_packed_experts"] = check_bnn_matmul_packed_experts(dev, gen)
    torch.cuda.empty_cache()
    print(f"expert kernel checks: {time.perf_counter() - t_moe} s")
    by_path, by_route = drive_moe_mla(dev, gen)
    lm_paths.update(by_path)
    records["bnn_matmul_packed_experts"].update(
        launches=by_path["qwen3 serving"]["bnn_matmul_packed_experts"], launches_by_route=by_route)
    print(f"MoE / MLA phase: {time.perf_counter() - t_moe} s")

    t_ssm = time.perf_counter()
    print("SSM / hybrid / VLM / audio phase:")
    lm_paths.update(drive_ssm_families(dev, gen))
    print(f"SSM / hybrid / VLM / audio phase: {time.perf_counter() - t_ssm} s")

    t_train = time.perf_counter()
    print("training phase:")
    lm_paths.update(drive_training(dev))
    print(f"training phase: {time.perf_counter() - t_train} s")

    t_dry = time.perf_counter()
    print("dry-run phase:")
    by_path, prefill_times = drive_dryrun(dev, gen)
    lm_paths.update(by_path)
    names = {"mma": "ms_mma", "tiled (forced)": "ms_tiled_forced", "torch.matmul bf16": "library_ms_torch_matmul",
             "torch._int_mm int8": "ms_torch_int_mm", "bound": "bound_ms"}
    for m, by_shape in prefill_times.items():
        for (k, n), t in by_shape.items():
            for name, key in names.items():
                records["bnn_matmul_packed"][f"dryrun_prefill_M{m}_K{k}_N{n}_{key}"] = t[name]
    print(f"dry-run phase: {time.perf_counter() - t_dry} s")
    # Every LM path's launches of each LM kernel; the bit-pack kernel's LM
    # launches (its ``bitpack`` wrapper) beside its packet-path record.
    for name in ("bnn_matmul_packed", "bnn_matmul_mxu", "flash_attention", "bnn_matmul_packed_experts",
                 *ATTENTION_KERNELS):
        records[name]["launches_by_path"] = {path: got.get(name, 0) for path, got in lm_paths.items()}
    records["pack_bits_words"]["bitpack_launches_by_path"] = {
        path: got.get("bitpack", 0) for path, got in lm_paths.items()}

    kernels = [
        dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
             launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r.get("library_ms"),
             **{key: value for key, value in r.items() if key not in CONTRACT_KEYS})
        for name, r in records.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
