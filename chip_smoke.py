#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its result; any failure exits non-zero:

1. the card's name and power limit, then the build of every kernel of the
   port's paths from the sources in this checkout (``lstm_cell``,
   ``ternary``, ``rmsnorm``, ``flash_attention``, ``flash_attention_bwd``),
   one ``nvcc`` per source, all started together (timed), with each
   kernel's registers, shared memory and spills, and the count of HGMMA
   (tensor-core) instructions in the two flash libraries' SASS where
   ``cuobjdump`` exists; the redesigned backward kernels
   (``NEW_BWD_KERNELS``) must not spill;
2. each kernel against its plain PyTorch version on the card, and its time
   at the main path's shapes beside the plain version, the one-call PyTorch
   equivalent (where one exists) and the card's bound: ``lstm_cell`` over
   the JAX package's test sweep and the paper's shapes (fp32 and bf16);
   ``lstm_seq`` (the whole-sequence kernel the model runs) over the same
   shapes at T = 40, against its plain version and bit for bit against 40
   chained ``lstm_cell`` launches, timed at the paper's two layers beside
   its bound, the plain version, a CUDA graph replaying 40 ``lstm_cell``
   launches and cuDNN's ``torch.nn.LSTM`` on the same weights;
   ``lstm_seq_bwd`` (backpropagation through time, one launch a layer:
   ``lstm_seq_bwd_staged_kernel`` on the paper's layers) and its
   yardstick (``lstm_seq_bwd_kernel``, the first one) over the same shapes and
   at sequences past one shared-memory window against its plain version
   (the per-step loop), fp32 within 2e-5 and bf16 within 2e-2 of max
   |grad|, two runs bit-equal, and ``_Seq``'s gradients at the paper's
   layers with and without dx against the plain BPTT, timed at the
   paper's layers and the sweep's register-tier shapes in turns with the
   yardstick (events, and the device time a launch from profiled windows
   whose launch count is held; faster than the yardstick by device time
   at the paper's layers, no slower at the sweep's), with both kernels'
   clock-stamp split of a step, beside its bound, the plain loop, the
   layer's forward + backward and cuDNN ``nn.LSTM``'s forward + backward;
   each LSTM kernel at the widest input its wrapper
   takes (just inside its launcher's shared memory: ``lstm_cell`` at Din +
   H = 7,264, ``lstm_seq`` at Din = 19,254, ``lstm_seq_bwd`` at H = 5,808)
   against its plain version in both dtypes, one wider refused before any
   launch; ``ternary_encode`` byte for byte and ``ternary_decode`` bit for bit (the
   single-leaf counterparts of the Pallas bodies) over the JAX sweep and the
   six paper leaves (padded, with values planted at ``±s/2`` and their
   neighbours), every byte value decoded at s = 0.37, inf and NaN (NaN as
   NaN); the gradient-level kernels (error feedback, encode, decode: every
   leaf in one launch) over the planted leaves as one 6-leaf tree, against
   their plain versions and the per-leaf chain of single-leaf launches, bit
   for bit, and the codec on leaves holding inf and NaN, card vs CPU; their
   times per call at the paper's gradient, at one leaf of 2^26 and at 64
   leaves summing to 2^26, beside the plain versions, the per-leaf chain
   and the bound, with error feedback's kernels and device time per launch
   under the profiler; ``rmsnorm`` over the JAX sweep (fp32,
   bf16, rows aligned or not) and qwen1.5-110b's prefill and decode rows
   ``[4096, 8192]`` / ``[4, 8192]`` bf16 (against ``F.rms_norm``), with
   the wrapper's host cost step by step at the decode rows;
   ``flash_attention`` over the JAX sweep x {causal, window 37, full} x
   {fp32, bf16}, the sweep again at hd = 128 in bf16, at hd = 192 (built
   natively, nemotron-4-340b's width) and at hd = 80 (zero-padded to 128)
   in both dtypes, at hd = 200 (padded to 256), 256, 576 and 1,024 in both
   dtypes (bf16 on the tensor-core routes, fp32 on ``tf32x3``, the
   three-product TF32 split, at every width; causal, with and without a
   window; every route these sizes reach taken), one call
   of more than 2^31 elements (q ``[257,1024,64,128]`` bf16, one launch;
   entries held bit for bit against the kernel on that entry alone and
   against the plain version), one batch entry of exactly 2^31 elements (q
   ``[1,131072,128,128]``, window 256, bf16 and fp32; its first and last
   1,024 rows against the plain version on slices), a batch past the
   grid's 65,535 entries (two launches),
   and qwen1.5-110b's prefill, q ``[4,1024,64,128]``, k/v
   ``[4,1024,8,128]``, causal, in bf16 and fp32 with a near-uniform and a
   peaked softmax (the peaked fp32 case against an fp64 attention), timed
   in bf16 (the tensor-core kernel) against SDPA, in fp32 (``tf32x3``) at
   hd 128 and in both dtypes at hd 192, 256, 576 and 1,024 against the
   plain version, SDPA in the same dtype (naming the backend SDPA picked),
   the bound and the CUDA-core kernel each route replaced (its C function
   called in the same run and held to the plain version; the route must
   be faster, and faster than SDPA too for bf16 above 256 and fp32 from
   256), two runs bit-equal, fp32 with ptxas's registers and a model of
   its products and bytes, and held with peaked (x2) inputs at 256 and 576
   (bf16 at the qwen gate, fp32 against an fp64 attention); bf16 at hd 192
   (``flash_kernel_wgmma_pipe``) also timed in turns beside the kernel it
   replaced, ``flash_kernel_wgmma<192, 64>`` (its yardstick C function,
   held to the plain version too), which must be slower; bf16 at hd 33-192
   (``flash_kernel_wgmma_pipe``) held at the qwen gate at hd 192, 160,
   129, 128, 96, 64 and 48 over the masks with x2 inputs at 8, 12, 7 and 1
   query heads a kv head, lse too, two runs bit-equal, and at 64, 128 and
   192 bit for bit equal to ``flash_kernel_wgmma<HD, 64>`` where G divides
   the block's rows (``flash_pipe_gate``); at hd 64 and 128 timed in turns
   beside that yardstick at every config's forward shape (the C functions
   alone by CUDA events, then both and SDPA's forward by the profiler's
   device time, the bound by two products and by three), held at the qwen
   gate (x0.5, x2) with lse, faster than the yardstick at qwen's B=4
   prefill and no slower than its slowest turn elsewhere
   (``flash_fwd_pipe_times``); the build fails the run if ptxas spills in
   any of its instances or serializes its wgmma;
3. the gradient of ``lstm_loss`` at the paper width through the sequence
   kernel and its backpropagation through time against autograd through the
   per-step plain path on the card, and the ternary codec's
   error-feedback round trip (three steps) on the card against the CPU and
   against the per-leaf chain of single-leaf launches on the card, bit for
   bit;
4. the LSTM training paths, each through
   ``repro_torch.launch.train.run_paper`` (3 volunteers, 3 versions, the
   Coordinator) on the card with every launch count set to 0 just before
   and read just after: dense in process (model bit-equal to
   ``sequential_accumulated`` on the card, per-version losses against the
   CPU), dense over the wire (bit-equal to the same reference), TernGrad
   over the wire (the codec's byte count ``bytes_sent`` = maps x the
   ternary size of one gradient + reduces x the model; the bytes the wire
   moved, ``wire_bytes``, printed beside the dense wire run's), its
   in-process twin (bit-equal), and a short top-k run under deterministic
   mode, each run's launch counts held to its path (2 ``lstm_seq``, one a
   layer, 2 ``lstm_seq_bwd`` and no ``lstm_cell`` per map and, under
   TernGrad, 2 ternary
   error-feedback launches per map and no ternary encode or decode launch,
   else none); then the
   four dense/ternary x inproc/wire runs once more in reverse order, for
   their seconds per version;
5. where one map's time goes: wall time, and a ``torch.profiler`` window's
   device busy share, kernels and the device time a launch of ``lstm_seq``
   and ``lstm_seq_bwd``; the
   same for one ternary error feedback of a paper gradient (exactly 2
   kernels);
5b. the gateway: a real-apply ``GatewayServer`` on a thread serving the
   paper's LSTM at full width over loopback TCP and WebSocket to volunteer
   threads that compute real maps (``staleness:2``, 2 versions, 32
   updates): one TCP and one WS volunteer, each run's wire-fetched final
   model bit-equal to ``sequential_async`` on the card, ``local:4``
   bit-equal to ``sequential_local``, three racing volunteers ending at the
   final version with contiguous versions; every run with the counts set
   to 0 just before and read just after, ``map_compute`` counted by a
   wrapper: exactly 2 ``lstm_seq`` and 2 ``lstm_seq_bwd`` launches a map
   and no ``lstm_cell``;
   the server's applier alone on 16 staged paper gradients, batched and
   single, bit-equal to each other and to chained ``apply_one``, ms per
   drain; ``python -m repro_torch.core.gateway --serve --real-apply`` as a
   subprocess on the card with one volunteer, bit-equal to
   ``sequential_async`` and exiting 0; seconds per update beside the
   Coordinator's seconds per version, and the card's busy share over a
   profiled gateway run of 16 updates;
6. the serving path: qwen1.5-110b at full width cut to 4 of its 80 layers
   (7,927,349,248 parameters, bf16, random weights from seed 0) served by
   ``repro_torch.launch.serve.serve`` (8 requests in batches of 4, 1,024
   prompt tokens, 16 generated) with every count set to 0 just before and
   read just after: exactly 8 ``flash_attention`` launches, all on the
   tensor-core route, and 288 ``rmsnorm`` launches and no other (no
   backward launch); prefill
   ms, decode ms per token, tokens/s and
   peak memory; then the same weights through the plain versions on the
   card, teacher-forced on the served tokens, every step's logits within
   the stated share of the logits' scale (beside the noise floor: the plain
   path against itself with ``F.rms_norm``); a ``torch.profiler`` window
   over one prefill and one decode step; then the same 4-layer model in
   fp32 (prompt 512), its flash launches counted by route (all on
   ``tf32x3``), kernels against plain versions within 1e-4 of the logits'
   scale;
6b. deepseek-moe-16b at its published size (28 layers, d_model 2,048, 64
   routed experts top-6 + 2 shared, 16,879,568,896 parameters, bf16, random
   from seed 0; no reduction) served by ``serve`` with qwen's traffic and
   every count set to 0 just before and read just after: exactly 28 flash
   launches a prefill, all on ``wgmma``, 57 ``rmsnorm`` launches a prefill
   and a decode step, no backward launch; prefill ms, decode ms a step
   beside its bound (every step reads all the weights), tokens/s, peak
   memory; the sort dispatch against the dense oracle on the post-norm
   inputs of layers 0, 13 and 27 at a capacity where nothing drops; the
   kernel path against the plain path teacher-forced, the plain runs
   replaying the kernel run's expert choices (``RouteBook``), with the
   route flips and the dropped (token, expert) assignments at the default
   capacity printed; a profiled prefill and decode step by kernel kind;
   the flash forward at its attention shape (G = 1, hd 128) beside SDPA;
6c. falcon-mamba-7b at its published size (64 Mamba-1 layers, d_model
   4,096, d_inner 8,192, d_state 16; 7,272,665,088 parameters, bf16, random
   from seed 0; no reduction) served by ``serve`` with qwen's traffic and
   every count set to 0 just before and read just after: exactly 65
   ``rmsnorm`` launches a prefill and a decode step (64 norm1 + the final
   norm), no flash and no backward launch; prefill ms, decode ms a step
   beside its bound from the weights' bytes, tokens/s, peak memory; the
   kernel path against the plain path teacher-forced (printed, not gated:
   two plain versions of its 64 bf16 layers already lie farther apart than
   the 2% gate); a profiled prefill and decode step by kernel kind, with
   the device time the Mamba mixers and the selective scan's chunks span;
   the rmsnorm kernel held at TOL at the prefill's [4096, 4096] and a
   decode step's [4, 4096] in bf16 (``hold_family_kernels``); then the
   same model in fp32 (29.1 GB) held at 1e-4 of the logits' scale;
6d. jamba-v0.1-52b at full width and vocabulary cut to two of its four
   8-layer periods (16 layers: attention at 4 and 12, moe on the odd
   layers; 26,053,595,136 parameters, bf16) served the same way: exactly 33
   ``rmsnorm`` launches a step (norm1 + norm2 of 16 layers + the final
   norm) and 2 flash launches a prefill, all on ``wgmma``, none writing
   lse; the kernel path against the plain path with the expert choices
   replayed (printed, as falcon's; the flash kernel alone held at the 2%
   gate), the dropped assignments at capacity factor 1.25, a profiled
   prefill and decode step; rmsnorm held at its shapes as falcon's and the
   flash forward at the prefill's shape (B=4, S=1,024, 32 over 8 heads, hd
   128, causal, bf16) on the wgmma route, timed beside SDPA; then one
   period (8 layers) in fp32 held at 1e-4, routes replayed;
6e. whisper-base at its published size (6 encoder + 6 decoder layers,
   d_model 512, 8 heads, hd 64, LayerNorm, cross-attention, tied
   embeddings; 70,655,488 parameters, bf16, random from seed 0) served by
   ``serve`` (8 requests in batches of 4: 1,500 zero frame embeddings, the
   conv/mel front end stubbed as in the reference, a 64-token prompt, 16
   greedy tokens) with every count set to 0 just before and read just
   after: exactly 12 flash launches a prefill (6 non-causal at S 1,500, 6
   causal at S 64), all on ``wgmma``, none writing lse, no rmsnorm and no
   backward launch; prefill and decode ms beside the decode's bound; the
   kernel path against the plain path teacher-forced on the served tokens
   and frames (the flash kernel alone gated at 2e-2, the whole path too
   where two plain versions lie closer), a profiled prefill and decode
   step; the flash forward with and without lse at B 4, S 1,500, 8/8, hd
   64, non-causal (inputs x0.5 and x2, lse at 1e-5), timed beside SDPA,
   the plain version and the bound (``hold_family_kernels``); then the
   model in fp32 with frames from the seed at 1e-4;
6f. internvl2-1b at its published size (24 layers, d_model 896, 14 over 2
   heads, G = 7, hd 64, QKV bias, RMSNorm; 629,663,872 parameters, bf16)
   served the same way (256 zero patch embeddings, the ViT and projector
   stubbed, ahead of 1,024 prompt tokens; decode from position 1,280):
   exactly 24 flash launches a prefill (S 1,280, G = 7) on ``wgmma`` and 49
   rmsnorm a prefill and a decode step; the same holds, the flash kernel at
   B 4, S 1,280, causal, G = 7, and rmsnorm at d_model 896 (``[5120,
   896]`` and ``[4, 896]``, the warp-a-row kernel); the whole bf16 path and
   the flash kernel alone printed, not gated, since its two plain versions
   lie past 2% at 24 layers; the model in fp32 with patches from the seed
   at 1e-4;
7. the smoke configs of every family served, in fp32 (qwen1.5-110b;
   deepseek-moe-16b, arctic-480b; falcon-mamba-7b; jamba-v0.1-52b;
   whisper-base; internvl2-1b, with frames or patches from a numpy seed),
   the kernel path on the card against the plain path on the CPU (the runs
   with experts replaying the card's expert choices): equal greedy tokens
   and logits (and outside the dense family the forward's logits, and the
   router loss where there are experts) within the stated tolerance;
7b. the RMSNorm backward kernel (``rmsnorm_bwd``: one C call of two
   launches, dx and the blocks' column partials on the rows kernel of its
   tier, then dscale; no atomics) and its yardstick (the first kernels)
   against ``ref.rmsnorm_bwd`` over the JAX sweep in fp32 and bf16 and at
   ``RMS_BWD_SHAPES`` (``[4096, 896]``, internvl2-1b's, to ``[4096,
   8192]``) bf16, 2e-5 / 2e-2 of max |grad|, two runs bit-equal, a strided
   dy refused on the card; timed at ``RMS_BWD_SHAPES`` in turns with the
   yardstick (events over wrapper calls, and the device time a call from
   profiled windows in turns whose launch count is held; by their medians
   faster than the yardstick at ``[4096, 896]``, no slower elsewhere)
   beside the plain backward, ``F.rms_norm``'s forward + backward and
   backward alone, and its bound and the device time's share of it; the
   wrapper's host time step by step at ``[4096, 896]``;
8. the transformer kernels as training runs them, at full width: the flash
   backward kernels against the plain backward (both from the kernel
   forward's out and lse) over the JAX sweep x {causal, window 37, full} in
   fp32 (within 2e-5 of max |grad|) and bf16, the sweep at hd 128 in bf16
   (within 2e-2), and its GQA shape at hd 80, 192, 256 and 576 in both
   dtypes (bf16 on the tensor cores up to 256, hd 16, 32 and 80
   zero-padded; fp32 on the tensor cores as three TF32 products, route
   ``tf32x3``, at every width), each call
   counted on its route and as padded or not; the bf16 CUDA-core pair
   through its C functions at hd 192 and 576; one batch entry of exactly
   2^31 elements (window 256) on slices at hd 128 in both dtypes and at hd
   256 in bf16; the backward timed at qwen's prefill shape (bf16 at hd
   192, 256, 576 and 1,024; fp32 at 64, 128, 192, 256, 576 and 1,024)
   beside SDPA's forward + backward, its five-product bound (fp32 at the
   three-product TF32 rate and at the CUDA cores'), the plain backward and
   the CUDA-core pair it replaced (which must be slower; SDPA too, for
   bf16 above 256 and fp32 up to 256), two runs bit-equal, each launch's
   device time, with ptxas's registers and spills; the lse of every other
   forward route (hd 256 bf16 and fp32, 576 bf16 and fp32, 1,024 bf16)
   against the plain lse; ``FlashAttention``
   (the kernel's forward writing lse, then the backward kernels) at
   stablelm-1.6b's shape (B=1, S=4,096, 32 heads, hd 64),
   qwen1.5-110b's (S=1,024, 64 over 8 heads, hd 128),
   nemotron-4-340b's (S=4,096, 96 over 8 heads, hd 192), internvl2-1b's
   (S=4,096, 14 over 2 heads, G = 7, hd 64), all causal, and whisper-base's
   encoder (B=2, S=1,500, 8 heads, hd 64, non-causal), bf16: the
   lse against the plain lse, dq/dk/dv against the plain forward and
   backward within 2e-2 of max |grad| beside the bf16 plain path's distance
   from an fp32 one, the backward kernels against the plain backward on
   the same out and lse, the forward and backward launched from a fresh
   thread (whose first CUDA call is the tensor-map encode, as autograd's
   worker thread's can be) bit-equal to this thread's; at nemotron's shape the forward also held at the
   qwen gate and timed in turns, with and without lse, beside
   ``flash_kernel_wgmma<192, 64>`` (which must be slower) and SDPA's
   forward; ``RMSNorm`` forward + backward at ``[4096, 8192]``
   bf16; the forward with and without lse, the backward kernels (with
   ptxas's registers and spills), the plain backward, ``FlashAttention``'s
   forward + backward and SDPA's forward + backward timed beside their
   bounds;
9. the training path: stablelm-1.6b at its full published size (24
   layers, d_model 2,048, 1,644,367,872 parameters, bf16, random weights
   from seed 0) through ``repro_torch.launch.train.run_arch``: AdamW,
   batch 8 x 4,096 tokens in 8 microbatches, remat on, 4 steps (the first
   a warm-up), with every count set to 0 just before and read just after:
   exactly 384 ``flash_attention`` launches a step, all on the
   tensor-core route and all writing lse, 192 flash backward calls of 2
   launches each, all on the tensor-core route, no other kernel launch;
   seconds
   per step, tokens/s, model FLOP/s and peak memory; one step without
   remat (192 launches, 384 backward launches); a profiled step (busy
   share, top kernels, device ms under the flash backward); that
   step's gradients against every kernel swapped for its plain version
   (``plain_kernels``), beside an fp32 plain step; a ``--ckpt`` run
   of the smoke config loading back bit for bit; the stablelm, qwen,
   deepseek-moe-16b and arctic-480b smoke configs' step gradients card vs
   CPU (fp32; the moe CPU steps replaying the card's expert choices) and
   their exact launch counts, the forward's and the backward's on the
   ``tf32x3`` route, the RMSNorm backward's two a call;
9b. deepseek-moe-16b at full width and vocabulary cut to 2 of its 28
   layers (1,595,156,480 parameters, 591,669,248 active) through
   ``run_arch`` with stablelm's traffic (AdamW, 8 x 4,096 tokens, remat),
   every count set to 0 just before and read just after: 32 flash forward
   launches a step (all writing lse) and 32 backward launches, all on
   ``wgmma``, 72 ``rmsnorm`` and 80 ``rmsnorm_bwd`` launches (40 calls);
   seconds a step, tokens/s, model FLOP/s from the active parameters,
   peak memory; a profiled step; its loss and every gradient leaf against
   the all-plain step with the expert choices replayed;
9c. whisper-base at its published size through ``run_arch``: AdamW, 8 rows
   of 1,500 frames + 448 tokens in 4 microbatches, remat, 3 steps (the
   first a warm-up), every count set to 0 just before and read just after:
   96 flash forward launches a step (12 layers x 4 microbatches x 2 under
   remat, all writing lse; the encoder's non-causal) and 96 backward
   launches, all on ``wgmma``, no rmsnorm; seconds a step, positions/s,
   model FLOP/s, peak memory; a profiled step; its loss and every gradient
   leaf against the all-plain step;
9d. internvl2-1b at its published size the same way with stablelm's
   traffic (8 x 4,096 positions: 256 patches + 3,840 tokens, 8
   microbatches): 384 flash forward and 384 backward launches a step at G
   = 7, 776 rmsnorm and 784 ``rmsnorm_bwd`` launches (392 calls);
10. one layer of nemotron-4-340b at its full width (d_model 18,432, 96 over
   8 heads, hd 192, squared-ReLU d_ff 73,728; vocab cut to 4,096:
   3,605,114,880 parameters, bf16, random from seed 0) through
   ``run_arch``: SGD, 2 microbatches of 1 x 4,096 tokens, remat on, 2 steps
   (the first a warm-up), every count set to 0 just before and read just
   after: 4 flash and 4 flash backward launches a step, every forward and
   backward launch on the tensor-core route (the forwards on
   ``flash_kernel_wgmma_pipe``), none padded, no rmsnorm; seconds per
   step, tokens/s and peak memory; a profiled step (the device time under
   the flash backward's node and of the forward's kernels a launch,
   printed beside the card's name and power limit); that step's loss and gradients against the same step with
   ``ops.flash_attention_bwd`` patched to the plain backward;
11. the steps on a mesh (``phase_mesh``): a one-rank NCCL process group
   from a ``FileStore`` in a temporary directory, and ``make_host_mesh``'s
   ``DeviceMesh("cuda", (1, 1))`` over ("data", "model") under it, every
   module split over ``model`` where its spec allows (tensor parallel at
   one rank): stablelm-1.6b at full width cut to 2 layers, one
   ``run_arch`` step (``bind_train``; stablelm's traffic), its parameters
   stored as DTensors, then the same step under a ``seq_parallel``
   policy; qwen1.5-110b cut to 4 layers, deepseek-moe-16b cut to 2 and
   falcon-mamba-7b cut to 4, at full width, each one batch of 4 x 1,024
   prompt tokens prefilled and 15 tokens decoded through ``bind_prefill``
   / ``bind_decode``: each bit-equal to the same calls on the card's host
   mesh (the parameters and loss after the step; every step's logits and
   the tokens), every kernel launch count equal, and the collectives
   issued on the one-rank groups, by kind as many as
   ``spmd.step_collectives`` predicts from the specs; their calls, bytes
   and device ms (CUDA events around each call) printed.

The drivers bind their steps as the JAX package's do: ``serve`` through
``bind_prefill`` / ``bind_decode`` and ``run_arch`` through ``bind_train``
on the host mesh, which on one card without a process group runs the
model on plain tensors and issues no collective. Every serving and
training phase (6, 6b–6f, 7, 9, 9b–9d, 10, 11) starts with
``phase_memory``: reference cycles collected, the allocator's cache freed,
the memory allocated printed and held under 1 GB. Every profiled prefill
and training step holds the flash forward kernels it ran, by name (width
and warpgroups) and count, to what its path should run
(``check_fwd_kernels``).

The line before the last is a JSON object of per-kernel numbers; the last is
``{"ok": true, "device": {...}}``. With no CUDA card, or outside a checkout
of the repository, it fails before printing either.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s (main sets it
# from repro_torch.launch.mesh.HBM_BW) and fp32 FLOP/s outside the tensor
# cores — the kernel does its fp32 math on CUDA cores
PEAK_BYTES_S = None
PEAK_FP32_FLOP_S = 67e12

# the paper's gradient: 6 leaves; the codec counts ceil(n/4) + 4 bytes a
# leaf under TernGrad, 13,586 bytes in all against 216,980 dense; its error
# feedback is two launches (a scale pass, then codes, decoded gradient and
# residual) for the whole gradient
TERNARY_GRAD_BYTES = 13_586
TERNARY_EF_LAUNCHES = 2

# tolerances of the JAX package's kernel tests (tests/test_kernels.py::_tol)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-5
# GPU vs CPU per-version losses: the two devices sum in different orders, and
# RMSprop at lr 0.1 turns a last-bit difference in a small gradient into a
# visible step (|step| ~ lr * sign(g) once |g| >> eps), so later versions
# drift apart more than float rounding alone would make them
CPU_LOSS_TOL = 1e-3

SWEEP = [(1, 7, 5), (8, 96, 50), (16, 128, 128), (5, 33, 200)]
# lstm_seq_bwd against the plain loop, of max |grad|: the kernel sums each
# dh_next in its own fixed order (four fmaf chains a unit, added pairwise),
# the plain loop through cuBLAS; fp32 at tests/test_kernels.py::_tol's 2e-5,
# bf16 (the same fp32 math from bf16 inputs) at its 2e-2
LSTM_BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the backward kernels redesigned for Hopper, none of which may
# spill; their yardsticks (the first backward kernels) stay bound and are
# timed beside them in rounds of turns (yardstick, kernel, kernel,
# yardstick)
NEW_BWD_KERNELS = ("rmsnorm_bwd_warp_kernel", "rmsnorm_bwd_block_kernel",
                   "lstm_seq_bwd_staged_kernel")
BWD_TURNS = 3
# sequences past one shared-memory window of the staged kernel (register
# tier, both dtypes): (T, B, Din, H)
LSTM_BWD_LONG = ((200, 8, 50, 50), (257, 3, 20, 64))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, torch, reps: int = 50, inner: int = 20,
              warm: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls each, in ms
    per call, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def in_turns(torch, kernel, yardstick, rounds=BWD_TURNS, **kw):
    """CUDA-event ms a call of ``kernel`` and of ``yardstick`` (each a
    ``median_ms`` over back-to-back calls), in ``rounds`` rounds of turns
    (yardstick, kernel, kernel, yardstick): {"kernel": [ms, ...],
    "yardstick": [ms, ...]}."""
    out = {"kernel": [], "yardstick": []}
    for _ in range(rounds):
        for name in ("yardstick", "kernel", "kernel", "yardstick"):
            out[name].append(median_ms(
                kernel if name == "kernel" else yardstick, torch, **kw))
    return out


def device_ms_counted(torch, fn, launches):
    """Device ms a call of ``fn`` and {kernel: ms a launch} from a profiled
    window of PIPE_REPS calls, each kernel's mean a launch times its
    launches a call. The window's launch count is held: the profiler loses
    a window's first event most of the time on these short windows, so a
    window may lack up to one call's ``launches`` and no more; a window
    short of that, or with other kernels, is taken again, up to
    PIPE_TRIES; (None, {}) when none held (not measured)."""
    for attempt in range(PIPE_TRIES):
        by_name = profiled(torch, fn, reps=PIPE_REPS, tries=1)[3]
        seen = sum(n for n, _ in by_name.values())
        per_call = {name: round(n / PIPE_REPS)
                    for name, (n, _) in by_name.items()}
        want = launches * PIPE_REPS
        if want - launches <= seen <= want and \
                sum(per_call.values()) == launches:
            kernels = {re.sub(r"^void |\(anonymous namespace\)::", "",
                              name): t / n
                       for name, (n, t) in by_name.items()}
            return (sum(by_name[name][1] / by_name[name][0] * c
                        for name, c in per_call.items()), kernels)
        print(f"[profile] window {attempt + 1} of {PIPE_TRIES} recorded "
              f"{seen} of its {want} launches ({per_call}); taken again")
    return None, {}


def device_in_turns(torch, kernel, yardstick, launches, rounds=BWD_TURNS):
    """``device_ms_counted`` of ``kernel`` and of ``yardstick`` in
    ``rounds`` rounds of turns (yardstick, kernel, kernel, yardstick):
    ({"kernel": [ms, ...], "yardstick": [ms, ...]}, the kernel's first
    {kernel: ms a launch}, the yardstick's); a window that held no count
    is left out (not measured)."""
    out = {"kernel": [], "yardstick": []}
    names = {}
    for _ in range(rounds):
        for who in ("yardstick", "kernel", "kernel", "yardstick"):
            ms, by_kernel = device_ms_counted(
                torch, kernel if who == "kernel" else yardstick, launches)
            if ms is not None:
                out[who].append(ms)
                names.setdefault(who, by_kernel)
    return out, names.get("kernel", {}), names.get("yardstick", {})


def fmt_turns(ms):
    return "/".join(f"{m:.5f}" for m in ms)


def cell_inputs(torch, B, Din, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, Din, generator=g)
    h = torch.randn(B, H, generator=g)
    c = torch.randn(B, H, generator=g)
    w = torch.randn(Din + H, 4 * H, generator=g) * 0.1
    b = torch.randn(4 * H, generator=g) * 0.1
    return [t.to(device="cuda", dtype=dtype).contiguous()
            for t in (x, h, c, w, b)]


def cell_bound_ms(B, Din, H, elem_bytes):
    """Least time for one cell step: each input read once, each output
    written once, over HBM; the gate product and gate math over fp32 peak."""
    moved = elem_bytes * (B * Din + 2 * B * H + (Din + H) * 4 * H + 4 * H
                          + 2 * B * H)
    ops = 2 * B * (Din + H) * 4 * H + 4 * B * H + 12 * B * H
    return max(moved / PEAK_BYTES_S, ops / PEAK_FP32_FLOP_S) * 1e3, \
        "bytes" if moved / PEAK_BYTES_S >= ops / PEAK_FP32_FLOP_S else \
        "operations"


def paper_shapes():
    """(B, Din, H) of the paper's two layers: mini-batch 8, one-hot input
    over the corpus's vocabulary, then 50 cells."""
    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.data.text import CharVocab, repo_corpus

    vocab = CharVocab.from_text(repo_corpus()).size
    H = CONFIG.d_model
    return [(8, vocab, H), (8, H, H)]          # layer 0, layer 1


def phase_kernel(torch, K, ref, paper):
    """Kernel vs plain version over the sweep and the paper shapes; times at
    the paper shapes. Returns the numbers of the kernel line."""
    worst = 0.0
    for B, Din, Hh in SWEEP + paper:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            args = cell_inputs(torch, B, Din, Hh, dtype, seed=B * 1000 + Din)
            hk, ck = K.lstm_cell(*args)
            hp, cp = ref.lstm_cell(*args)
            torch.cuda.synchronize()
            tol = TOL[name]
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in ((hk, hp), (ck, cp)))
            ok = all(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)
                     for a, b in ((hk, hp), (ck, cp)))
            print(f"[kernel] lstm_cell B={B} Din={Din} H={Hh} {name}: "
                  f"max|kernel-plain|={err:.3e} tol={tol} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"lstm_cell disagrees with its plain version at "
                      f"B={B} Din={Din} H={Hh} {name}")
            if name == "float32" and (B, Din, Hh) in paper:
                worst = max(worst, err)

    rows = []
    for B, Din, Hh in paper:
        x, h, c, w, b = cell_inputs(torch, B, Din, Hh, torch.float32, seed=7)
        w_ih, w_hh = w[:Din].t().contiguous(), w[Din:].t().contiguous()
        b_hh = torch.zeros_like(b)
        ms = median_ms(lambda: K.lstm_cell(x, h, c, w, b), torch)
        plain_ms = median_ms(lambda: ref.lstm_cell(x, h, c, w, b), torch)
        lib_ms = median_ms(
            lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh), torch)
        bound, by = cell_bound_ms(B, Din, Hh, 4)
        print(f"[kernel] lstm_cell time B={B} Din={Din} H={Hh} fp32: "
              f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"torch.lstm_cell {lib_ms:.5f} ms, bound {bound:.6f} ms "
              f"({by})")
        rows.append(dict(shape=[B, Din, Hh], ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by))
    return worst, rows


SEQ_T = 40             # the paper's sample length: a sequence launch's steps


def seq_inputs(torch, T, B, Din, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, B, Din, generator=g)
    h = torch.randn(B, H, generator=g) * 0.5
    c = torch.randn(B, H, generator=g) * 0.5
    w = torch.randn(Din + H, 4 * H, generator=g) * 0.1
    b = torch.randn(4 * H, generator=g) * 0.1
    return [t.to(device="cuda", dtype=dtype).contiguous()
            for t in (x, h, c, w, b)]


def seq_bound_ms(T, B, Din, H, elem_bytes):
    """Least time for one layer over a sequence: x_seq, W, b, h0 and c0 read
    once, hs and cs (input type) and the gates (fp32) written once, over
    HBM; T steps of the gate product and gate math at the fp32 peak."""
    moved = elem_bytes * (T * B * Din + (Din + H) * 4 * H + 4 * H + 2 * B * H
                          + 2 * T * B * H) + 4 * T * B * 4 * H
    ops = T * (2 * B * (Din + H) * 4 * H + 16 * B * H)
    t_b, t_o = moved / PEAK_BYTES_S, ops / PEAK_FP32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def chained_cells(K, x, h, c, w, b):
    """len(x) lstm_cell launches, each fed the last one's outputs."""
    hs, cs = [], []
    for xt in x:
        h, c = K.lstm_cell(xt, h, c, w, b)
        hs.append(h)
        cs.append(c)
    return hs, cs


def cell_graph(torch, K, x, h, c, w, b):
    """A CUDA graph of len(x) chained lstm_cell launches on these (static)
    inputs: (replay, the graph's hs, cs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chained_cells(K, x, h, c, w, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        hs, cs = chained_cells(K, x, h, c, w, b)
    return graph.replay, hs, cs


def cudnn_module(torch, w, b, Din):
    """cuDNN's LSTM (``torch.nn.LSTM``, gate order i, f, g, o as Keras's)
    with the layer's W [Din+H, 4H] and b carried across."""
    lstm = torch.nn.LSTM(Din, w.shape[1] // 4).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w[:Din].t())
        lstm.weight_hh_l0.copy_(w[Din:].t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    return lstm


def cudnn_lstm(torch, x, h, c, w, b):
    """cuDNN's LSTM over x [T,B,Din]: the one-call yardstick, for
    comparison only. Returns the call, which gives hs."""
    lstm = cudnn_module(torch, w, b, x.shape[-1])

    def run():
        with torch.no_grad():
            return lstm(x, (h[None], c[None]))[0]
    return run


def phase_lstm_seq(torch, K, ref, paper):
    """lstm_seq against its plain version and bit for bit against SEQ_T
    chained lstm_cell launches, over the sweep and the paper's layers (fp32,
    bf16); its time at the paper's layers beside its bound, the plain
    version, a CUDA graph of SEQ_T lstm_cell launches and cuDNN's LSTM.
    The launches here are comparisons, made before any path's counts are
    reset. Returns (worst fp32 error at the paper's layers, rows)."""
    worst = 0.0
    for B, Din, Hh in SWEEP + paper:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x, h, c, w, b = seq_inputs(torch, SEQ_T, B, Din, Hh, dtype,
                                       seed=B * 1000 + Din)
            got = K.lstm_seq(x, h, c, w, b)
            want = ref.lstm_seq(x, h, c, w, b)
            hs, cs = chained_cells(K, x, h, c, w, b)
            torch.cuda.synchronize()
            tol = TOL[name]
            err = max((a.float() - p.float()).abs().max().item()
                      for a, p in zip(got, want))
            ok = all(torch.allclose(a.float(), p.float(), rtol=tol, atol=tol)
                     for a, p in zip(got, want))
            same = all(torch.equal(got[0][t], hs[t]) and
                       torch.equal(got[1][t], cs[t]) for t in range(SEQ_T))
            print(f"[kernel] lstm_seq T={SEQ_T} B={B} Din={Din} H={Hh} "
                  f"{name}: max|kernel-plain| over hs, cs, gates={err:.3e} "
                  f"tol={tol} {'ok' if ok else 'FAIL'}; bit-equal to "
                  f"{SEQ_T} chained lstm_cell launches: {same}")
            check(ok, f"lstm_seq disagrees with its plain version at B={B} "
                      f"Din={Din} H={Hh} {name}")
            check(same, f"lstm_seq differs from {SEQ_T} chained lstm_cell "
                        f"launches at B={B} Din={Din} H={Hh} {name}")
            if name == "float32" and (B, Din, Hh) in paper:
                worst = max(worst, err)

    rows = []
    for B, Din, Hh in paper:
        x, h, c, w, b = seq_inputs(torch, SEQ_T, B, Din, Hh, torch.float32,
                                   seed=7)
        ms = median_ms(lambda: K.lstm_seq(x, h, c, w, b), torch)
        plain_ms = median_ms(lambda: ref.lstm_seq(x, h, c, w, b), torch,
                             reps=10, inner=5)
        replay, g_hs, _ = cell_graph(torch, K, x, h, c, w, b)
        graph_ms = median_ms(replay, torch)
        same = torch.equal(g_hs[-1], K.lstm_seq(x, h, c, w, b)[0][-1])
        check(same, "the CUDA graph of lstm_cell launches and lstm_seq "
                    "end on different h")
        # cuDNN may pick algorithms that deterministic mode refuses: off for
        # it alone (timed, never run by the port)
        torch.use_deterministic_algorithms(False)
        try:
            lib = cudnn_lstm(torch, x, h, c, w, b)
            lib_err = (lib() - ref.lstm_seq(x, h, c, w, b)[0]).abs().max() \
                .item()
            cudnn_ms = median_ms(lib, torch)
        finally:
            torch.use_deterministic_algorithms(True)
        bound, by = seq_bound_ms(SEQ_T, B, Din, Hh, 4)
        print(f"[kernel] lstm_seq time T={SEQ_T} B={B} Din={Din} H={Hh} fp32: "
              f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, CUDA graph of "
              f"{SEQ_T} lstm_cell launches {graph_ms:.5f} ms (same last h: "
              f"{same}), cuDNN nn.LSTM {cudnn_ms:.5f} ms (max|cuDNN-plain| "
              f"{lib_err:.3e}), bound {bound:.6f} ms ({by})")
        rows.append(dict(shape=[SEQ_T, B, Din, Hh], ms=ms, plain_ms=plain_ms,
                         graph_ms=graph_ms, cudnn_ms=cudnn_ms,
                         cudnn_err=lib_err, bound_ms=bound, bound_by=by))
    return worst, rows


def lstm_bwd_bound_ms(T, B, H, elem_bytes):
    """Least time for one layer's backpropagation through time: dhs, cs, c0
    and W_h read once (input type), the gates read once and dz, dh0, dc0
    written once (fp32), over HBM; T steps of dz_t W_h^T and the gate
    chain at the fp32 peak."""
    moved = elem_bytes * (2 * T * B * H + B * H + 4 * H * H) + \
        4 * (2 * T * B * 4 * H + 2 * B * H)
    ops = T * B * (2 * H * 4 * H + 20 * H)
    t_b, t_o = moved / PEAK_BYTES_S, ops / PEAK_FP32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def cudnn_lstm_fb(torch, x, h, c, w, b, dhs, x_grad):
    """cuDNN's LSTM forward + backward over x [T,B,Din] with W and b carried
    across, the gradients of (h0, c0, its weights and, with ``x_grad``, x)
    for the cotangent dhs: the one-call yardstick of the layer under
    autograd, for comparison only. Returns the call."""
    lstm = cudnn_module(torch, w, b, x.shape[-1])
    xs = x.detach().clone().requires_grad_(x_grad)
    h0, c0 = (t[None].detach().clone().requires_grad_() for t in (h, c))
    wrt = [h0, c0, *lstm.parameters()] + ([xs] if x_grad else [])

    def run():
        return torch.autograd.grad(lstm(xs, (h0, c0))[0], wrt, dhs)
    return run


def seq_layer_grads(torch, leaves, dhs, x_grad):
    """Gradients of one ``models/lstm.py::_Seq`` layer (the sequence kernel
    forward, then ``ops.lstm_seq_bwd`` and the products) for the cotangent
    dhs: of (h0, c0, kernel, bias) and, with ``x_grad``, x first."""
    from repro_torch.models.lstm import _Seq
    xs = [t.detach().clone().requires_grad_(i > 0 or x_grad)
          for i, t in enumerate(leaves)]
    return torch.autograd.grad(_Seq.apply(*xs), xs if x_grad else xs[1:],
                               dhs)


def stamp_split(torch, K, args, staged):
    """The stamp instantiation of the staged kernel (``staged``) or of the
    yardstick at ``args``: the mean SM cycles of each phase of a step
    (K.STAMP_PHASES after the first: the gate update, the barrier, the
    dh_next chains, the shuffles), of a whole step, of the launch's steps
    end to end, and before and after them (the kernel's entry to the
    first step, the last step to its exit), and the staged kernel's
    prologue stamps from its entry (K.STAMP_ENDS)."""
    K.lstm_seq_bwd_stamps(*args, staged=staged)
    st, ends = (t.cpu().double() for t in
                K.lstm_seq_bwd_stamps(*args, staged=staged)[3:])
    phases = st[:, 1:] - st[:, :-1]
    steps = st[:-1, 0] - st[1:, 0]          # step t - 1 starts after step t
    out = dict({p: phases[:, i].mean().item()
                for i, p in enumerate(K.STAMP_PHASES[1:])},
               step=steps.mean().item(),
               all_steps=(st[0, -1] - st[-1, 0]).item(),
               before_steps=(st[-1, 0] - ends[0]).item(),
               after_steps=(ends[1] - st[0, -1]).item())
    # the staged kernel's prologue, from its entry
    for i, name in enumerate(K.STAMP_ENDS[2:], 2):
        if ends[i] > 0:
            out[f"to {name}"] = (ends[i] - ends[0]).item()
    return out


def phase_lstm_bwd(torch, K, ref, paper):
    """lstm_seq_bwd (the staged kernel on the register tier, the first
    kernel above it) and its yardstick (``K.lstm_seq_bwd_yardstick``, the
    first kernel at every width) against the plain version (the per-step
    loop) over the sweep and the paper's layers, fp32 and bf16, twice
    (bit-equal runs), and at sequences past one shared-memory window
    (``LSTM_BWD_LONG``); ``_Seq``'s gradients at the paper's layers, with
    and without dx, through the kernel against ``plain_kernels()`` (the
    plain BPTT after the same forward kernel); the kernel and its
    yardstick timed in turns at the paper's layers and at the sweep's
    register-tier shapes (CUDA events over back-to-back calls), their
    device time a launch (a profiled window, its launch count held), the
    stamp split of a step of each, beside the bound, the plain loop, the
    layer's forward + backward and cuDNN ``nn.LSTM``'s forward + backward.
    The kernel must be faster than the yardstick by device time at the
    paper's layers and no slower at the sweep's register-tier shapes (the
    calls are host-bound, so the events read the host).
    The launches here are comparisons, made before any path's counts are
    reset. Returns (worst fp32 relative and absolute errors at the paper's
    layers, rows)."""
    worst, worst_abs = 0.0, 0.0
    cases = [(SEQ_T, *shape) for shape in SWEEP + paper] + \
        list(LSTM_BWD_LONG)
    for T, B, Din, Hh in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x, h, c, w, b = seq_inputs(torch, T, B, Din, Hh, dtype,
                                       seed=B * 1000 + Din)
            _, cs, gates = K.lstm_seq(x, h, c, w, b)
            dhs = randn(torch, (T, B, Hh), dtype, B + Din)
            got = K.lstm_seq_bwd(dhs, gates, cs, c, w[Din:])
            again = K.lstm_seq_bwd(dhs, gates, cs, c, w[Din:])
            yard = K.lstm_seq_bwd_yardstick(dhs, gates, cs, c, w[Din:])
            want = ref.lstm_seq_bwd(dhs, gates, cs, c, w[Din:])
            torch.cuda.synchronize()
            errs = [rel_err(torch, a, p) for a, p in zip(got, want)]
            yerrs = [rel_err(torch, a, p) for a, p in zip(yard, want)]
            same = all(torch.equal(a, r) for a, r in zip(got, again))
            ok = max(errs) <= LSTM_BWD_TOL[name] and \
                max(yerrs) <= LSTM_BWD_TOL[name]
            print(f"[kernel] lstm_seq_bwd T={T} B={B} Din={Din} H={Hh} "
                  f"{name} ({K.bwd_tier(Hh)}): max|kernel-plain| / max|grad| "
                  f"over dz, dh0, dc0 {', '.join(f'{e:.3e}' for e in errs)} "
                  f"(yardstick {', '.join(f'{e:.3e}' for e in yerrs)}) tol "
                  f"{LSTM_BWD_TOL[name]} {'ok' if ok else 'FAIL'}; two runs "
                  f"bit-equal: {same}")
            check(ok, f"lstm_seq_bwd or its yardstick disagrees with the "
                      f"plain version at T={T} B={B} Din={Din} H={Hh} {name}")
            check(same, f"lstm_seq_bwd differs between two runs at T={T} "
                        f"B={B} Din={Din} H={Hh} {name}")
            if name == "float32" and (B, Din, Hh) in paper and T == SEQ_T:
                worst = max(worst, max(errs))
                worst_abs = max(worst_abs, max(
                    (a - p).abs().max().item() for a, p in zip(got, want)))

    for B, Din, Hh in paper:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            leaves = seq_inputs(torch, SEQ_T, B, Din, Hh, dtype, seed=11)
            dhs = randn(torch, (SEQ_T, B, Hh), dtype, 12)
            for x_grad in (True, False):
                gk = seq_layer_grads(torch, leaves, dhs, x_grad)
                with plain_kernels():
                    gp = seq_layer_grads(torch, leaves, dhs, x_grad)
                errs = [rel_err(torch, a, p) for a, p in zip(gk, gp)]
                ok = max(errs) <= LSTM_BWD_TOL[name]
                print(f"[kernel] _Seq layer B={B} Din={Din} H={Hh} {name} "
                      f"{'with' if x_grad else 'without'} dx: gradients "
                      f"through lstm_seq_bwd vs the plain BPTT, max|diff| / "
                      f"max|grad| {', '.join(f'{e:.3e}' for e in errs)} "
                      f"({'dx, ' if x_grad else ''}dh0, dc0, dW, db) tol "
                      f"{LSTM_BWD_TOL[name]} {'ok' if ok else 'FAIL'}")
                check(ok, f"_Seq gradients through lstm_seq_bwd disagree at "
                          f"B={B} Din={Din} H={Hh} {name} x_grad={x_grad}")

    rows = []
    for layer, (B, Din, Hh) in enumerate(paper):
        x, h, c, w, b = seq_inputs(torch, SEQ_T, B, Din, Hh, torch.float32,
                                   seed=7)
        _, cs, gates = K.lstm_seq(x, h, c, w, b)
        dhs = randn(torch, (SEQ_T, B, Hh), torch.float32, 13)
        args = (dhs, gates, cs, c, w[Din:])
        turns = in_turns(torch, lambda: K.lstm_seq_bwd(*args),
                         lambda: K.lstm_seq_bwd_yardstick(*args))
        ms = statistics.median(turns["kernel"])
        yard_ms = statistics.median(turns["yardstick"])
        dev, dev_names = device_ms_counted(
            torch, lambda: K.lstm_seq_bwd(*args), 1)
        yard_dev, yard_names = device_ms_counted(
            torch, lambda: K.lstm_seq_bwd_yardstick(*args), 1)
        split = {"kernel": stamp_split(torch, K, args, True),
                 "yardstick": stamp_split(torch, K, args, False)}
        plain_ms = median_ms(lambda: ref.lstm_seq_bwd(*args), torch, reps=10,
                             inner=5)
        # as the model trains: layer 0's one-hot input needs no gradient
        x_grad = layer > 0
        fb_ms = median_ms(lambda: seq_layer_grads(torch, (x, h, c, w, b), dhs,
                                                  x_grad), torch, reps=20,
                          inner=5)
        torch.use_deterministic_algorithms(False)
        try:
            cudnn_fb_ms = median_ms(cudnn_lstm_fb(torch, x, h, c, w, b, dhs,
                                                  x_grad), torch, reps=20,
                                    inner=5)
        finally:
            torch.use_deterministic_algorithms(True)
        bound, by = lstm_bwd_bound_ms(SEQ_T, B, Hh, 4)
        share = "not measured" if dev is None else f"{100 * bound / dev:.2f}%"
        print(f"[kernel] lstm_seq_bwd time T={SEQ_T} B={B} Din={Din} H={Hh} "
              f"fp32, in turns: kernel {fmt_turns(turns['kernel'])} ms "
              f"(median {ms:.5f}), yardstick "
              f"{fmt_turns(turns['yardstick'])} ms (median {yard_ms:.5f}); "
              f"device time a launch: kernel {fmt_ms(dev)} {dev_names}, "
              f"yardstick {fmt_ms(yard_dev)} {yard_names}; bound "
              f"{bound:.6f} ms ({by}, {share} of it by device time); plain "
              f"loop {plain_ms:.4f} ms; the "
              f"layer's forward + backward "
              f"({'with' if x_grad else 'without'} dx) {fb_ms:.4f} ms, cuDNN "
              f"nn.LSTM forward + backward {cudnn_fb_ms:.4f} ms")
        print(f"[kernel] lstm_seq_bwd stamps T={SEQ_T} B={B} Din={Din} "
              f"H={Hh} fp32, mean SM cycles a step (block 0, thread 0): " +
              "; ".join(f"{who}: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in sp.items())
                  for who, sp in split.items()))
        # both wrappers' calls are host-bound (the events read the host),
        # so the verdict is the device time's
        check(dev is not None and yard_dev is not None and dev < yard_dev,
              f"lstm_seq_bwd at B={B} Din={Din} H={Hh} is not faster than "
              f"its yardstick by device time: {dev} / {yard_dev} ms")
        rows.append(dict(shape=[SEQ_T, B, Din, Hh], ms=ms, turns=turns,
                         yardstick_ms=yard_ms, device_ms=dev,
                         yardstick_device_ms=yard_dev, stamps=split,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         fwd_bwd_ms=fb_ms, cudnn_fwd_bwd_ms=cudnn_fb_ms))
    # the sweep's register-tier shapes: no slower than the yardstick
    for B, Din, Hh in SWEEP:
        if K.bwd_tier(Hh) != "staged":
            continue
        x, h, c, w, b = seq_inputs(torch, SEQ_T, B, Din, Hh, torch.float32,
                                   seed=9)
        _, cs, gates = K.lstm_seq(x, h, c, w, b)
        args = (randn(torch, (SEQ_T, B, Hh), torch.float32, 14), gates, cs,
                c, w[Din:])
        turns = in_turns(torch, lambda: K.lstm_seq_bwd(*args),
                         lambda: K.lstm_seq_bwd_yardstick(*args), rounds=2,
                         reps=20, inner=10)
        dev = [device_ms_counted(torch, fn, 1)[0] for fn in (
            lambda: K.lstm_seq_bwd(*args),
            lambda: K.lstm_seq_bwd_yardstick(*args))]
        print(f"[kernel] lstm_seq_bwd time T={SEQ_T} B={B} Din={Din} H={Hh} "
              f"fp32, in turns: kernel {fmt_turns(turns['kernel'])} ms, "
              f"yardstick {fmt_turns(turns['yardstick'])} ms; device time a "
              f"launch: kernel {fmt_ms(dev[0])}, yardstick {fmt_ms(dev[1])}")
        check(None not in dev and dev[0] <= dev[1],
              f"lstm_seq_bwd at the sweep's B={B} Din={Din} H={Hh} is "
              f"slower than its yardstick by device time: {dev}")
        rows[0].setdefault("sweep", {})[f"{B}x{Din}x{Hh}"] = dict(
            turns=turns, device_ms=dev[0], yardstick_device_ms=dev[1])
    return worst, worst_abs, rows


# the LSTM launchers' shared-memory ceilings (kernels/lstm_cell.py
# smem_bytes): each kernel's widest input its wrapper takes, launched at a
# small T and B against its plain version; one wider is refused
CEILING_T, CEILING_B, CEILING_H = 3, 2, 50


def fan_in_scaled(inputs):
    """``cell_inputs`` / ``seq_inputs`` with the kernel W [n, 4H] drawn at
    1/sqrt(n) (the scale of a Glorot-style initialisation) instead of 0.1:
    a pre-activation then stays O(1) at any width, as in a trained layer.
    At 0.1 a sum of 19,304 terms reaches |z| ~ 14, and its fp32 rounding in
    two summation orders alone differs by more than the fp32 gate."""
    x, h, c, w, b = inputs
    scale = 10.0 / math.sqrt(w.shape[0])
    return [x, h, c, (w.float() * scale).to(w.dtype).contiguous(), b]


def lstm_ceiling(K, what, H=None):
    """The widest input of ``what`` the wrapper takes: Din at the given H
    (``lstm_cell``, ``lstm_seq``), or H (``lstm_seq_bwd``)."""
    n = 1
    while True:
        din, h = (n + 1, H) if H is not None else (0, n + 1)
        if K.smem_bytes(what, din, h)[0] > K.MAX_SMEM:
            return n
        n += 1


def phase_lstm_ceilings(torch, K, ref):
    """Each LSTM kernel at the widest input its wrapper takes (just inside
    its launcher's shared memory) against its plain version, both dtypes:
    ``lstm_cell`` at Din + H = 7,264, ``lstm_seq`` at Din = 19,254 (H =
    50), ``lstm_seq_bwd`` at H = 5,808; one step wider, the wrapper refuses
    on the card too, before any launch."""
    T, B, Hh = CEILING_T, CEILING_B, CEILING_H
    din_cell = lstm_ceiling(K, "lstm_cell", Hh)
    din_seq = lstm_ceiling(K, "lstm_seq", Hh)
    h_bwd = lstm_ceiling(K, "lstm_seq_bwd")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        args = fan_in_scaled(cell_inputs(torch, B, din_cell, Hh, dtype,
                                         seed=31))
        got, want = K.lstm_cell(*args), ref.lstm_cell(*args)
        err = max((a.float() - p.float()).abs().max().item()
                  for a, p in zip(got, want))
        ok = all(torch.allclose(a.float(), p.float(), rtol=tol, atol=tol)
                 for a, p in zip(got, want))
        print(f"[kernel] lstm_cell at its ceiling B={B} Din={din_cell} "
              f"H={Hh} {name} ({K.smem_bytes('lstm_cell', din_cell, Hh)[0]:,} "
              f"of {K.MAX_SMEM:,} bytes): max|kernel-plain|={err:.3e} "
              f"tol={tol} {'ok' if ok else 'FAIL'}")
        check(ok, f"lstm_cell disagrees at its ceiling ({name})")
        x, h, c, w, b = fan_in_scaled(seq_inputs(torch, T, B, din_seq, Hh,
                                                 dtype, seed=32))
        got, want = K.lstm_seq(x, h, c, w, b), ref.lstm_seq(x, h, c, w, b)
        err = max((a.float() - p.float()).abs().max().item()
                  for a, p in zip(got, want))
        ok = all(torch.allclose(a.float(), p.float(), rtol=tol, atol=tol)
                 for a, p in zip(got, want))
        print(f"[kernel] lstm_seq at its ceiling T={T} B={B} Din={din_seq} "
              f"H={Hh} {name}: max|kernel-plain| over hs, cs, gates "
              f"{err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
        check(ok, f"lstm_seq disagrees at its ceiling ({name})")
        x, h, c, w, b = fan_in_scaled(seq_inputs(torch, T, B, 8, h_bwd,
                                                 dtype, seed=33))
        _, cs, gates = K.lstm_seq(x, h, c, w, b)
        dhs = randn(torch, (T, B, h_bwd), dtype, 34)
        got = K.lstm_seq_bwd(dhs, gates, cs, c, w[8:])
        want = ref.lstm_seq_bwd(dhs, gates, cs, c, w[8:])
        torch.cuda.synchronize()
        errs = [rel_err(torch, a, p) for a, p in zip(got, want)]
        ok = max(errs) <= LSTM_BWD_TOL[name]
        print(f"[kernel] lstm_seq_bwd at its ceiling T={T} B={B} H={h_bwd} "
              f"{name}: max|kernel-plain| / max|grad| over dz, dh0, dc0 "
              f"{', '.join(f'{e:.3e}' for e in errs)} tol "
              f"{LSTM_BWD_TOL[name]} {'ok' if ok else 'FAIL'}")
        check(ok, f"lstm_seq_bwd disagrees at its ceiling ({name})")
        del x, h, c, w, b, cs, gates, dhs, got, want
    before = (K.lstm_cell.launches, K.lstm_seq.launches,
              K.lstm_seq_bwd.launches)
    for what, fn, args in (
            ("lstm_cell", K.lstm_cell,
             cell_inputs(torch, B, din_cell + 1, Hh, torch.float32, 35)),
            ("lstm_seq", K.lstm_seq,
             seq_inputs(torch, T, B, din_seq + 1, Hh, torch.float32, 36))):
        try:
            fn(*args)
            check(False, f"{what} took an input past its ceiling")
        except ValueError as e:
            print(f"[kernel] {what} one past its ceiling refused: {e}")
    g = torch.zeros(T, B, 4 * (h_bwd + 1), device="cuda")
    hb = torch.zeros(T, B, h_bwd + 1, device="cuda")
    try:
        K.lstm_seq_bwd(hb, g, hb, hb[0], torch.zeros(
            h_bwd + 1, 4 * (h_bwd + 1), device="cuda"))
        check(False, "lstm_seq_bwd took an input past its ceiling")
    except ValueError as e:
        print(f"[kernel] lstm_seq_bwd one past its ceiling refused: {e}")
    check((K.lstm_cell.launches, K.lstm_seq.launches,
           K.lstm_seq_bwd.launches) == before,
          "an input past an LSTM ceiling was launched")
    return dict(lstm_cell=din_cell + Hh, lstm_seq=din_seq, lstm_seq_bwd=h_bwd)


# the six leaves of the paper's gradient (head b, head w, layer 0 bias and
# kernel, layer 1 bias and kernel), their element counts before padding
PAPER_LEAVES = [95, 4750, 200, 29000, 200, 20000]
TERNARY_SWEEP = [4, 128, 4096, 10000]      # tests/test_kernels.py
# the large sizes the gradient-level kernels are timed at: one leaf of 2^26
# fp32 and 64 leaves summing to 2^26
TERNARY_LARGE = {"1 x 2^26": [2 ** 26], "64 x 2^20": [2 ** 20] * 64}
# bytes an element each gradient-level call must move: encode reads g and
# writes its 2-bit code; decode the reverse; error feedback reads g and r
# and writes the decoded value, the residual and the code
TERNARY_BYTES = {"encode": 4.25, "decode": 4.25, "ef_compress": 16.25}


def ternary_bound_ms(n, per_elem=4.25, n_leaves=1):
    """Least time for a call over n (padded) elements: ``per_elem`` bytes
    an element and a scale a leaf crossed once at HBM rate; the ~4
    operations per element (abs, compare, select, shift-or) at fp32
    peak."""
    moved = per_elem * n + 4 * n_leaves
    ops = 4 * n
    t_b, t_o = moved / PEAK_BYTES_S, ops / PEAK_FP32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def planted_leaf(torch, n, seed, s=None):
    """A padded leaf of n values with the threshold's edge planted: s
    itself first (so it is the max), then s/2, its two float neighbours and
    their negatives. ``s`` given (a power of two, say) scales the leaf to
    it."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g)
    n4 = -(-n // 4) * 4
    x = torch.cat([x, torch.zeros(n4 - n)])
    scale = torch.tensor(float(s) if s is not None else 1.7, dtype=torch.float32)
    x = (x / x.abs().max() * scale * 0.999).float()
    half = scale / 2
    edge = torch.stack([half, torch.nextafter(half, torch.tensor(0.0)),
                        torch.nextafter(half, torch.tensor(float("inf")))])
    plant = torch.cat([scale.reshape(1), edge, -edge])
    k = min(len(plant), n)
    x[:k] = plant[:k]
    return x


def bits_equal(torch, a, b) -> bool:
    """Bit-for-bit equality of two fp32 tensors (+0.0 and -0.0 differ)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def nan_equal(torch, a, b) -> bool:
    """Bit-for-bit equality of two fp32 tensors, except that any NaN
    matches any NaN (the card's canonical NaN is not the CPU's)."""
    a, b = a.float().cpu(), b.float().cpu()
    if a.shape != b.shape or not torch.equal(a.isnan(), b.isnan()):
        return False
    keep = ~a.isnan()
    return torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))


def max_finite_err(torch, got, want) -> float:
    """max |got - want| over the values both hold finite (0 where none)."""
    pairs = [(a.float().cpu().reshape(-1), b.float().cpu().reshape(-1))
             for a, b in zip(got, want)]
    errs = [(a - b)[a.isfinite() & b.isfinite()].abs() for a, b in pairs]
    return max((e.max().item() for e in errs if e.numel()), default=0.0)


def per_leaf_chain(torch, T, gs, rs):
    """Error feedback leaf by leaf through the single-leaf wrappers (the
    Pallas bodies' counterparts), as the codec ran before the gradient-level
    pass: (packed, s, decoded, residual) per leaf, on the card."""
    out = []
    for g, r in zip(gs, rs):
        c = g + r
        n = c.numel()
        s = torch.clamp_min(c.abs().max(), 1e-12)
        flat = torch.cat([c.reshape(-1), c.new_zeros(-n % 4)])
        packed = T.ternary_encode(flat, s)
        d = T.ternary_decode(packed, s)[:n].reshape(c.shape)
        out.append((packed[:-(-n // 4)], s, d, c - d))
    return out


def ternary_leaves(torch, sizes, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(n, generator=g, device="cuda") * scale
            for n in sizes]


def phase_ternary(torch, T, ref):
    """The single-leaf wrappers (the Pallas bodies' counterparts) byte for
    byte and bit for bit against their plain versions, every byte value
    decoded at s = 0.37, inf and NaN; the gradient-level kernels (error
    feedback, encode, decode) against theirs and against the per-leaf chain
    over the planted leaves as a 6-leaf tree, and at non-finite scales.
    Then times: the single-leaf pair at the paper's largest leaf, and every
    gradient-level call at the paper's gradient and at 2^26 elements (one
    leaf, 64 leaves) beside its plain version, the per-leaf chain and its
    bound. The launches here are comparisons, made before any path's
    counts are reset."""
    cases = [(f"sweep N={n}", planted_leaf(torch, n, seed=n)) for n in
             TERNARY_SWEEP]
    cases += [(f"paper leaf n={n}", planted_leaf(torch, n, seed=7 + i))
              for i, n in enumerate(PAPER_LEAVES)]
    cases += [(f"paper leaf n={n} s=2.0", planted_leaf(torch, n, seed=11,
                                                       s=2.0))
              for n in (95, 29000)]
    worst = {"enc": 0, "dec": 0.0}
    for name, x in cases:
        g = x.cuda()
        s = torch.clamp_min(g.abs().max(), 1e-12)
        pk, pp = T.ternary_encode(g, s), ref.ternary_encode_packed(g, s)
        dk, dp = T.ternary_decode(pk, s), ref.ternary_decode_packed(pk, s)
        torch.cuda.synchronize()
        enc_ok = torch.equal(pk, pp)
        dec_ok = bits_equal(torch, dk, dp)
        worst["enc"] = max(worst["enc"], (pk.int() - pp.int()).abs()
                           .max().item())
        worst["dec"] = max(worst["dec"], (dk - dp).abs().max().item())
        print(f"[kernel] ternary {name}: encode bytes equal {enc_ok}, "
              f"decode bits equal {dec_ok}, {int((pk != 0).sum())} nonzero "
              f"bytes")
        check(enc_ok, f"ternary_encode differs from its plain version "
                      f"({name})")
        check(dec_ok, f"ternary_decode differs from its plain version "
                      f"({name})")
    # every byte value, codes 0b11 included, decodes as the plain version,
    # at a finite scale and at the two non-finite ones (0 * s is NaN there)
    every = torch.arange(256, dtype=torch.uint8, device="cuda")
    for sv in (0.37, float("inf"), float("nan")):
        s = torch.tensor(sv, device="cuda")
        ok = nan_equal(torch, T.ternary_decode(every, s),
                       ref.ternary_decode_packed(every, s))
        print(f"[kernel] ternary_decode of all 256 byte values at s={sv} "
              f"equal to the plain version (NaN as NaN): {ok}")
        check(ok, f"ternary_decode differs from its plain version at "
                  f"s={sv}")

    grad_err = phase_ternary_leaves(torch, T, ref)
    phase_ternary_non_finite(torch)

    n = max(PAPER_LEAVES)
    g = planted_leaf(torch, n, seed=3).cuda()
    s = g.abs().max()
    pk = T.ternary_encode(g, s)
    bound, by = ternary_bound_ms(n)
    rows = {}
    for key, kern, plain in (
            ("encode", lambda: T.ternary_encode(g, s),
             lambda: ref.ternary_encode_packed(g, s)),
            ("decode", lambda: T.ternary_decode(pk, s),
             lambda: ref.ternary_decode_packed(pk, s))):
        ms = median_ms(kern, torch)
        plain_ms = median_ms(plain, torch)
        print(f"[kernel] ternary_{key} (single leaf) time N={n} fp32: kernel "
              f"{ms:.5f} ms, plain {plain_ms:.5f} ms, no one-call PyTorch "
              f"equivalent, bound {bound:.6f} ms ({by})")
        rows[key] = dict(single_leaf=dict(n=n, ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound, bound_by=by))
    rows["encode"]["max_abs_err"] = max(worst["enc"], grad_err["encode"])
    rows["decode"]["max_abs_err"] = max(worst["dec"], grad_err["decode"])
    rows["ef_compress"] = {"max_abs_err": grad_err["ef_compress"]}
    for name, sizes in [("paper", PAPER_LEAVES)] + list(TERNARY_LARGE.items()):
        for key, row in ternary_times(torch, T, ref, sizes, name).items():
            if name == "paper":
                rows[key].update(row)
            else:
                rows[key][name] = row
    return rows


def phase_ternary_leaves(torch, T, ref):
    """The gradient-level kernels over the planted leaves as one 6-leaf
    tree (leaves of the paper's sizes, each with the threshold's edge) and
    over a tree of leaves of 1, 3, 4, 5 and 4,750: error feedback (packed
    codes, scales, decoded, residual), encode (scales found and given) and
    decode, bit for bit against the plain versions and the per-leaf chain
    on the card. Returns the worst |kernel - plain| of each."""
    worst = {"encode": 0.0, "decode": 0.0, "ef_compress": 0.0}
    trees = {"planted paper leaves": PAPER_LEAVES,
             "leaves of 1, 3, 4, 5, 4750": [1, 3, 4, 5, 4750]}
    for name, sizes in trees.items():
        gs = [planted_leaf(torch, n, seed=70 + i)[:n].cuda()
              for i, n in enumerate(sizes)]
        rs = [x * 0.01 for x in ternary_leaves(torch, sizes, seed=5)]
        got = T.ef_compress_leaves(gs, rs, payload=True)
        want = ref.ternary_ef(gs, rs, payload=True)
        chain = list(zip(*per_leaf_chain(torch, T, gs, rs)))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got[0], want[0])) and \
            all(bits_equal(torch, a.reshape(-1), b.reshape(-1))
                for k in (1, 2, 3) for a, b in zip(got[k], want[k]))
        as_chain = all(torch.equal(a, b) for a, b in zip(got[0], chain[0])) \
            and all(bits_equal(torch, a.reshape(-1), b.reshape(-1))
                    for k in (1, 2, 3) for a, b in zip(got[k], chain[k]))
        worst["ef_compress"] = max(worst["ef_compress"], max_finite_err(
            torch, got[2] + got[3], want[2] + want[3]))
        pk, sk = T.encode_leaves(gs)
        pw, sw = ref.ternary_encode_leaves(gs)
        pk2, _ = T.encode_leaves(gs, sw)
        dk = T.decode_leaves(pk, sk, [g.shape for g in gs])
        dw = ref.ternary_decode_leaves(pw, sw, [g.shape for g in gs])
        torch.cuda.synchronize()
        enc = all(torch.equal(a, b) for a, b in zip(pk, pw)) and \
            all(torch.equal(a, b) for a, b in zip(pk2, pw)) and \
            all(bits_equal(torch, a.reshape(-1), b.reshape(-1))
                for a, b in zip(sk, sw))
        dec = all(bits_equal(torch, a, b) for a, b in zip(dk, dw))
        worst["decode"] = max(worst["decode"], max_finite_err(torch, dk, dw))
        print(f"[kernel] ternary gradient level, {name}: error feedback "
              f"(codes, scales, decoded, residual) bit-equal to the plain "
              f"version {same} and to the per-leaf chain of single-leaf "
              f"launches {as_chain}; encode (scales found, given) "
              f"{enc}; decode {dec}")
        check(same and as_chain and enc and dec,
              f"gradient-level ternary kernels differ ({name})")
    return worst


def phase_ternary_non_finite(torch):
    """The codec on a gradient with a leaf holding inf and one holding NaN:
    error feedback, encode and decode on the card against the CPU, NaN as
    NaN (every value of such a leaf decodes to 0 * s = NaN, as in the JAX
    codec), the finite leaves bit for bit."""
    from repro_torch import tree
    from repro_torch.optim import compression as TC
    g = torch.Generator().manual_seed(9)
    grads = {"inf": torch.randn(4750, generator=g),
             "nan": torch.randn(200, generator=g),
             "ok": torch.randn(50, 95, generator=g)}
    grads["inf"][17] = float("inf")
    grads["nan"][3] = float("nan")
    codec = TC.make_codec("ternary")
    res = {}
    for dev in ("cuda", "cpu"):
        gd = tree.to_device(grads, dev)
        r = tree.map(lambda x: x * 0.01, gd)
        d, r2, n = TC.ef_compress(codec, gd, r)
        p, nb = TC.ternary_encode(gd)
        res[dev] = (tree.leaves((d, r2, TC.ternary_decode(p))),
                    [q["s"] for q in tree.leaves(p, is_leaf=TC._is_payload)],
                    [q["packed"] for q in tree.leaves(p,
                                                      is_leaf=TC._is_payload)],
                    (n, nb))
    torch.cuda.synchronize()
    (lc, sc, pc, nc), (lp, sp, pp, np_) = res["cuda"], res["cpu"]
    ok = all(nan_equal(torch, a, b) for a, b in zip(lc + sc, lp + sp)) and \
        all(torch.equal(a.cpu(), b) for a, b in zip(pc, pp)) and nc == np_
    nan_leaves = all(bool(x.isnan().all()) for x in
                     (res["cuda"][0][0], res["cuda"][0][1]))
    print(f"[codec] ternary codec with an inf leaf and a NaN leaf, card vs "
          f"CPU (NaN as NaN): equal {ok}; those leaves decode to NaN "
          f"throughout {nan_leaves}; nbytes {nc}")
    check(ok and nan_leaves, "the ternary codec at a non-finite scale "
                             "differs between the card and the CPU")


def ternary_times(torch, T, ref, sizes, name):
    """Per-call times of the gradient-level wrappers over leaves of these
    sizes, each beside its plain version (at the paper's size), the
    per-leaf chain of single-leaf launches and its bound; and error
    feedback under the profiler: kernels, device time per launch, host
    ms around a synchronize."""
    n = sum(sizes)
    large = n > 10 ** 6
    timing = dict(reps=10, inner=5) if large else {}
    gs = ternary_leaves(torch, sizes, seed=len(sizes))
    rs = [x * 0.01 for x in ternary_leaves(torch, sizes, seed=99)]
    pk, sk = T.encode_leaves(gs)
    shapes = [g.shape for g in gs]
    calls = {
        "encode": (lambda: T.encode_leaves(gs),
                   lambda: ref.ternary_encode_leaves(gs)),
        "decode": (lambda: T.decode_leaves(pk, sk, shapes),
                   lambda: ref.ternary_decode_leaves(pk, sk, shapes)),
        "ef_compress": (lambda: T.ef_compress_leaves(gs, rs),
                        lambda: ref.ternary_ef(gs, rs))}
    out = {}
    for key, (kern, plain) in calls.items():
        ms = median_ms(kern, torch, **timing)
        plain_ms = None if large else median_ms(plain, torch, reps=10,
                                                 inner=5)
        bound, by = ternary_bound_ms(n, TERNARY_BYTES[key], len(sizes))
        out[key] = dict(sizes=name, n=n, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by)
    out["ef_compress"]["chain_ms"] = median_ms(
        lambda: per_leaf_chain(torch, T, gs, rs), torch, reps=10, inner=2)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.ef_compress_leaves(gs, rs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    reps = 10
    window_ms, busy_ms, n_kernels, by_name, _ = profiled(
        torch, lambda: T.ef_compress_leaves(gs, rs), reps)
    window_ms, busy_ms, n_kernels = (window_ms / reps, busy_ms / reps,
                                     n_kernels / reps)
    out["ef_compress"].update(
        host_ms=statistics.median(walls[1:]), kernels=n_kernels,
        busy_ms=busy_ms, window_ms=window_ms,
        scale_device_ms=per_launch_ms(by_name, "ternary_scale_kernel"),
        ef_device_ms=per_launch_ms(by_name, "ternary_ef_kernel"))
    for key, kern, frag in (("encode", calls["encode"][0],
                             "ternary_encode_kernel"),
                            ("decode", calls["decode"][0],
                             "ternary_decode_kernel")):
        _, busy, n_k, names, _ = profiled(torch, kern, reps)
        out[key].update(kernels=n_k / reps, busy_ms=busy / reps,
                        device_ms=per_launch_ms(names, frag),
                        scale_device_ms=per_launch_ms(
                            names, "ternary_scale_kernel"))
    e = out["ef_compress"]
    print(f"[kernel] ternary gradient level, {len(sizes)} leaves ({name}): "
          f"device time a launch: encode {fmt_ms(out['encode']['device_ms'])}"
          f" (after a scale pass of "
          f"{fmt_ms(out['encode']['scale_device_ms'])}), decode "
          f"{fmt_ms(out['decode']['device_ms'])}")
    print(f"[kernel] ternary gradient level, {len(sizes)} leaves ({name}), "
          f"n={n}: per call encode {out['encode']['ms']:.5f} ms, decode "
          f"{out['decode']['ms']:.5f} ms, error feedback {e['ms']:.5f} ms "
          f"(bound {e['bound_ms']:.6f} ms at {TERNARY_BYTES['ef_compress']} "
          f"B an element, {100 * e['bound_ms'] / e['ms']:.1f}% of it; "
          f"encode/decode bound {out['encode']['bound_ms']:.6f} ms); plain "
          f"encode/decode/ef {fmt_ms(out['encode']['plain_ms'])} / "
          f"{fmt_ms(out['decode']['plain_ms'])} / {fmt_ms(e['plain_ms'])}; "
          f"per-leaf chain of single-leaf launches {e['chain_ms']:.5f} ms; "
          f"error feedback under the profiler: {n_kernels:g} kernels, device "
          f"time a launch scale {fmt_ms(e['scale_device_ms'])}, ef "
          f"{fmt_ms(e['ef_device_ms'])}; host {e['host_ms']:.4f} ms around "
          f"a synchronize")
    check(ternary_only(by_name) and
          0 < n_kernels <= TERNARY_EF_LAUNCHES * -(-len(sizes) // 64),
          f"error feedback over {len(sizes)} leaves ran {n_kernels:g} "
          f"kernels a call: {sorted(by_name)}")
    return out


def plain_loss(torch, ref, params, batch):
    """lstm_loss with every cell step in the plain version (autograd
    differentiates it directly): the reference for the gradient phase."""
    import torch.nn.functional as F
    xs = batch["x"].transpose(0, 1)
    for lp in params["layers"]:
        Hh = lp["kernel"].shape[1] // 4
        h = torch.zeros(xs.shape[1], Hh, device=xs.device)
        c = torch.zeros_like(h)
        hs = []
        for x in xs:
            h, c = ref.lstm_cell(x, h, c, lp["kernel"], lp["bias"])
            hs.append(h)
        xs = torch.stack(hs)
    logits = xs[-1] @ params["head"]["w"] + params["head"]["b"]
    logp = torch.log_softmax(logits, dim=-1)
    y = F.one_hot(batch["y"].long(), logp.shape[-1]).to(logp.dtype)
    return -(logp * y).sum(-1).mean()


def phase_grad(torch, ref):
    from repro_torch import tree
    from repro_torch.core.mapreduce import TrainingProblem

    prob = TrainingProblem.paper_problem(seed=0, device="cuda")
    batch = prob.minibatch(0, 0)
    loss_k, grads_k = prob.loss_and_grads(prob.params0, batch)
    leaves, spec = tree.flatten(prob.params0)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    b = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    loss_p = plain_loss(torch, ref, tree.unflatten(spec, leaves), b)
    grads_p = torch.autograd.grad(loss_p, leaves)
    torch.cuda.synchronize()
    err = max([abs(loss_k.item() - loss_p.item())] +
              [(a - b).abs().max().item()
               for a, b in zip(tree.leaves(grads_k), grads_p)])
    ok = torch.allclose(loss_k, loss_p.detach(), rtol=GRAD_TOL,
                        atol=GRAD_TOL) and all(
        torch.allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)
        for a, b in zip(tree.leaves(grads_k), grads_p))
    print(f"[grad] lstm_loss d_model={prob.cfg.d_model} vocab="
          f"{prob.cfg.vocab}: loss {loss_k.item():.6f}, max|kernel-plain| "
          f"over loss and grads {err:.3e} tol={GRAD_TOL} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "kernel-forward gradients disagree with the plain path")


def serve_counts(K, T):
    """The serve path's launch counts since ``reset_counts``: rmsnorm,
    flash, the rmsnorm backward and every other kernel together."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    return dict(rmsnorm=RN.rmsnorm.launches,
                flash_attention=FA.flash_attention.launches,
                rmsnorm_bwd=RN.rmsnorm_bwd.launches,
                others=K.lstm_cell.launches + K.lstm_seq.launches +
                K.lstm_seq_bwd.launches + FA.flash_attention_bwd.launches +
                T.ternary_encode.launches + T.ternary_decode.launches +
                T.ef_compress_leaves.launches)


def reset_counts(K, T):
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    for fn in (K.lstm_cell, K.lstm_seq, K.lstm_seq_bwd, T.ternary_encode,
               T.ternary_decode, T.ef_compress_leaves, RN.rmsnorm,
               RN.rmsnorm_bwd, FA.flash_attention, FA.flash_attention_bwd):
        fn.launches = 0
    for fn in (FA.flash_attention, FA.flash_attention_bwd):
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        fn.padded_launches = 0
    FA.flash_attention.lse_launches = 0


# what a serving or training phase may find allocated when it starts: the
# earlier phases' models and steps are gone by then
PHASE_START_GB = 1.0


def cuda_tensors_held(torch, top: int = 12):
    """The largest live CUDA tensors the garbage collector can see: (GB,
    shape, dtype, the types of the objects that refer to each)."""
    seen, rows = set(), []
    for obj in gc.get_objects():
        try:
            if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
                continue
        except ReferenceError:
            continue
        key = obj.untyped_storage().data_ptr()
        if key in seen:
            continue
        seen.add(key)
        refs = sorted({type(r).__name__ for r in gc.get_referrers(obj)})
        rows.append((obj.untyped_storage().nbytes() / 1e9,
                     tuple(obj.shape), str(obj.dtype), refs))
    return sorted(rows, key=lambda r: -r[0])[:top]


def host_mesh():
    """The card's host mesh (one device, no process group), which the
    drivers bind their steps to."""
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh("cuda")


def phase_memory(torch, tag) -> float:
    """The start of a serving or training phase: collect what only
    reference cycles hold, free the allocator's cache, print the memory
    allocated and fail unless it is under PHASE_START_GB (naming the
    largest tensors still held); then reset the peak. Returns the GB
    allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    gb = torch.cuda.memory_allocated() / 1e9
    print(f"[memory] {tag}: {gb:.3f} GB allocated at the phase's start "
          f"(limit {PHASE_START_GB} GB)")
    if gb >= PHASE_START_GB:
        for row in cuda_tensors_held(torch):
            print(f"[memory]   held: {row[0]:.3f} GB {row[1]} {row[2]}, "
                  f"referred to by {row[3]}")
    check(gb < PHASE_START_GB, f"{tag} starts with {gb:.3f} GB allocated")
    torch.cuda.reset_peak_memory_stats()
    return gb


def same_model(torch, res, ref_params, ref_state) -> bool:
    """The run's (params, opt_state) equal the reference's bit for bit."""
    from repro_torch import tree
    return all(a.dtype == b.dtype and (
        bits_equal(torch, a, b) if a.dtype == torch.float32
        else torch.equal(a, b)) for a, b in
        zip(tree.leaves((res.params, res.opt_state)),
            tree.leaves((ref_params, ref_state)), strict=True))


def phase_codec(torch, T):
    """The ternary codec's error-feedback chain on the card against the same
    chain on the CPU and against the per-leaf chain of single-leaf launches
    on the card, from the same three paper-width map gradients: the decoded
    gradients, the residuals and the byte counts must be equal bit for bit
    (the gradient-level kernels against their plain versions and against
    the previous per-leaf design, inside the codec)."""
    from repro_torch import tree
    from repro_torch.core.mapreduce import TrainingProblem
    from repro_torch.optim import ef_compress, ef_init, make_codec

    prob = TrainingProblem.paper_problem(seed=0, device="cuda")
    codec = make_codec("ternary")
    r_gpu, r_cpu = ef_init(prob.params0), ef_init(tree.to_device(
        prob.params0, "cpu"))
    r_chain = tree.leaves(r_gpu)
    for mb in range(3):
        g, _ = prob.map_compute(prob.params0, 0, mb)
        d_gpu, r_gpu, n_gpu = ef_compress(codec, g, r_gpu)
        d_cpu, r_cpu, n_cpu = ef_compress(codec, tree.to_device(g, "cpu"),
                                          r_cpu)
        chain = per_leaf_chain(torch, T, tree.leaves(g), r_chain)
        r_chain = [c[3] for c in chain]
        torch.cuda.synchronize()
        same = all(bits_equal(torch, a.cpu(), b) for a, b in zip(
            tree.leaves((d_gpu, r_gpu)), tree.leaves((d_cpu, r_cpu)),
            strict=True))
        as_chain = all(bits_equal(torch, a, b) for a, b in zip(
            tree.leaves((d_gpu, r_gpu)),
            [c[2] for c in chain] + r_chain, strict=True))
        print(f"[codec] ternary ef_compress step {mb + 1}: decoded and "
              f"residual card == cpu bit for bit: {same}; == the per-leaf "
              f"chain of single-leaf launches on the card: {as_chain}; "
              f"nbytes {n_gpu} (cpu {n_cpu}, dense {prob.grad_bytes})")
        check(same, f"ternary codec step {mb + 1} differs between the card "
                    f"and the CPU")
        check(as_chain, f"ternary codec step {mb + 1} differs from the "
                        f"per-leaf chain")
        check(n_gpu == n_cpu == TERNARY_GRAD_BYTES,
              f"ternary nbytes {n_gpu}/{n_cpu}, expected "
              f"{TERNARY_GRAD_BYTES}")


def phase_main_path(torch, K, T):
    from repro_torch.core.mapreduce import TrainingProblem, sequential_accumulated
    from repro_torch.launch.train import run_paper

    workers, versions = 3, 3
    reset_counts(K, T)
    t0 = time.time()
    prob, res = run_paper(workers=workers, versions=versions, seed=0,
                          device="cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches, cell_launches = K.lstm_seq.launches, K.lstm_cell.launches
    bwd_launches = K.lstm_seq_bwd.launches
    maps = sum(res.tasks_by_worker.values()) - versions
    print(f"[main] Coordinator workers={workers} versions={versions}: "
          f"{dt / versions:.3f} s per version, {maps} maps, "
          f"{launches} lstm_seq launches ({prob.seq_launches_per_map} a map), "
          f"{bwd_launches} lstm_seq_bwd launches, {cell_launches} lstm_cell "
          f"launches, losses {res.losses}")
    check(res.final_version == versions,
          f"final version {res.final_version}, expected {versions}")
    check(all(math.isfinite(l) for l in res.losses), "non-finite loss")
    check(maps == versions * prob.tp.mini_batches_to_accumulate,
          f"{maps} maps ran, expected "
          f"{versions * prob.tp.mini_batches_to_accumulate}")
    check(launches == prob.seq_launches_per_map * maps,
          f"{launches} lstm_seq launches, expected "
          f"{prob.seq_launches_per_map} x {maps}")
    # backpropagation through time: one launch a layer a map, as forward
    check(bwd_launches == prob.seq_launches_per_map * maps,
          f"{bwd_launches} lstm_seq_bwd launches, expected "
          f"{prob.seq_launches_per_map} x {maps}")
    check(cell_launches == 0, f"{cell_launches} lstm_cell launches on the "
                              f"training path, expected none")

    check(T.ternary_encode.launches == T.ternary_decode.launches ==
          T.ef_compress_leaves.launches == 0,
          "the dense path launched a ternary kernel")
    p_seq, s_seq, l_seq = sequential_accumulated(prob, n_versions=versions)
    same = same_model(torch, res, p_seq, s_seq)
    print(f"[main] Coordinator == sequential_accumulated on the card, bit for "
          f"bit: {same}")
    check(same, "Coordinator run on the card differs from "
                "sequential_accumulated on the card")

    prob_cpu = TrainingProblem.paper_problem(seed=0, device="cpu")
    _, _, l_cpu = sequential_accumulated(prob_cpu, n_versions=versions)
    diff = max(abs(a - b) for a, b in zip(res.losses, l_cpu, strict=True))
    print(f"[main] per-version losses card {res.losses} vs cpu {l_cpu}: "
          f"max diff {diff:.3e} tol={CPU_LOSS_TOL}")
    check(diff <= CPU_LOSS_TOL, "card and CPU loss trajectories differ")
    return prob, (launches, cell_launches, bwd_launches), (p_seq, s_seq), \
        dt / versions


def phase_wire_paths(torch, K, T, prob, seq, dense_s):
    """The gradient wire: dense over the wire, TernGrad over the wire and in
    process, and a short top-k run, each through ``run_paper`` with every
    count set to 0 just before and read just after, and held to its path."""
    from repro_torch.launch.train import run_paper

    workers, versions = 3, 3
    n_mb = prob.tp.mini_batches_to_accumulate
    maps = versions * n_mb

    def run(codec, transport, w=workers, v=versions):
        reset_counts(K, T)
        t0 = time.time()
        _, res = run_paper(workers=w, versions=v, seed=0, device="cuda",
                           codec=codec, transport=transport)
        torch.cuda.synchronize()
        dt = time.time() - t0
        counts = (K.lstm_seq.launches, K.lstm_cell.launches,
                  T.ef_compress_leaves.launches, T.ternary_encode.launches,
                  T.ternary_decode.launches, K.lstm_seq_bwd.launches)
        tag = f"{codec}/{transport}"
        check(res.final_version == v, f"{tag}: final version "
                                      f"{res.final_version}, expected {v}")
        check(all(math.isfinite(l) for l in res.losses),
              f"{tag}: non-finite loss")
        n_maps = sum(res.tasks_by_worker.values()) - v
        check(n_maps == v * n_mb, f"{tag}: {n_maps} maps, expected "
                                  f"{v * n_mb}")
        # error feedback: a scale pass and one encode-decode-residual
        # launch a gradient, no encode or decode launch of their own
        ef = TERNARY_EF_LAUNCHES * n_maps if codec == "ternary" else 0
        want = (prob.seq_launches_per_map * n_maps, 0, ef, 0, 0,
                prob.seq_launches_per_map * n_maps)
        check(counts == want, f"{tag}: launches lstm_seq/lstm_cell/"
                              f"ternary ef/encode/decode/lstm_seq_bwd "
                              f"{counts}, expected {want}")
        check((res.wire_bytes is not None) == (transport == "wire"),
              f"{tag}: wire_bytes {res.wire_bytes}")
        print(f"[wire] codec={codec} transport={transport}: "
              f"{dt / v:.3f} s per version (dense inproc {dense_s:.3f}), "
              f"launches lstm_seq/lstm_cell/ternary ef/encode/decode/"
              f"lstm_seq_bwd {counts} (expected), "
              f"codec bytes_sent {res.bytes_sent}, wire_bytes "
              f"{res.wire_bytes}, losses {res.losses}")
        return res, counts, dt / v

    dense_wire, _, dense_wire_s = run("none", "wire")
    same = same_model(torch, dense_wire, *seq)
    print(f"[wire] dense wire run == sequential_accumulated on the card, bit "
          f"for bit: {same}")
    check(same, "dense wire run differs from sequential_accumulated")

    tern_wire, counts, tern_wire_s = run("ternary", "wire")
    want = maps * TERNARY_GRAD_BYTES + versions * prob.model_bytes
    print(f"[wire] ternary codec bytes_sent {tern_wire.bytes_sent} = {maps} "
          f"maps x {TERNARY_GRAD_BYTES} + {versions} reduces x "
          f"{prob.model_bytes} (dense gradients would count "
          f"{prob.grad_bytes} each): {tern_wire.bytes_sent == want}")
    check(tern_wire.bytes_sent == want, f"ternary bytes_sent "
                                        f"{tern_wire.bytes_sent}, want {want}")
    wire_bytes = {"none/wire": dense_wire.wire_bytes,
                  "ternary/wire": tern_wire.wire_bytes}
    print(f"[wire] bytes the wire moved (requests, replies, notifications): "
          f"dense {dense_wire.wire_bytes}, ternary {tern_wire.wire_bytes} "
          f"(the gradient crosses decoded; ratio "
          f"{tern_wire.wire_bytes / dense_wire.wire_bytes:.4f})")

    tern_inproc, _, tern_inproc_s = run("ternary", "inproc")
    same = same_model(torch, tern_wire, tern_inproc.params,
                      tern_inproc.opt_state)
    print(f"[wire] ternary wire run == ternary inproc run, bit for bit: "
          f"{same}")
    check(same, "the wire changed the ternary run's model")

    run("topk", "inproc", w=2, v=1)

    # the four paths once more in the reverse order, for time only, so each
    # path's seconds per version is a mean over an early and a late slot
    first = {"ternary/inproc": tern_inproc_s, "ternary/wire": tern_wire_s,
             "none/wire": dense_wire_s, "none/inproc": dense_s}
    per_version = {}
    for key, s1 in first.items():
        _, _, s2 = run(*key.split("/"))
        per_version[key] = dict(runs=[s1, s2], mean=(s1 + s2) / 2)
    base = per_version["none/inproc"]["mean"]
    for key, row in per_version.items():
        print(f"[wire] {key}: {row['mean']:.3f} s per version (runs "
              f"{row['runs'][0]:.3f}, {row['runs'][1]:.3f}), "
              f"{100 * (row['mean'] / base - 1):+.1f}% against dense inproc")
    return counts, per_version, wire_bytes


def flash_fwd_launches() -> int:
    """The flash forward wrapper's launch count so far."""
    from repro_torch.kernels import flash_attention as FA
    return FA.flash_attention.launches


def lost_launches(kernels, launched: int):
    """What a profiled window's device events (``kernels``) lack of the
    ``launched`` flash forward launches the wrapper counted in it (one
    kernel a launch), as words; None where none is missing."""
    seen = sum(1 for e in kernels if fwd_name(e.name))
    if seen >= launched:
        return None
    return f"{seen} of the {launched} flash forward launches made in it"


def profiled(torch, fn, reps: int = 1, tries: int = 3):
    """Run ``fn`` ``reps`` times under ``torch.profiler``: (window ms on the
    host clock, device busy ms, kernel count, {kernel name: (launches,
    ms)}, [(host op or runtime call, calls, self host ms)] by self time),
    over all ``reps`` runs. A window whose device trace the profiler lost
    (now and then all of a short window's, or part of one: ``lost_launches``)
    is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()   # the window holds fn's work alone
        before = flash_fwd_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        lost = lost_launches(kernels, flash_fwd_launches() - before)
        if kernels and not lost:
            break
        print(f"[profile] window {attempt + 1} of {tries} recorded "
              f"{lost or 'no device event'}; taken again")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    host = sorted(((a.key, a.count, a.self_cpu_time_total / 1e3)
                   for a in prof.key_averages()), key=lambda r: -r[2])
    return window_ms, busy_ms, len(kernels), by_name, host


def ternary_only(by_name) -> bool:
    """Every kernel of a profiled window is the ternary scale pass or the
    error-feedback kernel: no torch op launched anything around them."""
    return all("ternary_scale_kernel" in name or "ternary_ef_kernel" in name
               for name in by_name)


def per_launch_ms(by_name, fragment):
    hits = [(n, t) for name, (n, t) in by_name.items() if fragment in name]
    return sum(t for _, t in hits) / sum(n for n, _ in hits) if hits else None


def launches_named(by_name, fragment):
    return sum(n for name, (n, _) in by_name.items() if fragment in name)


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.5f} ms"


def phase_profile(torch, prob):
    """Where the time goes on the card: one map's wall time without and
    with ``torch.profiler``, the device's busy share inside the profiled
    window and the kernels that fill it; then the same for one ternary
    error-feedback round trip of a paper gradient. Runs after the launch
    counts were read, so its launches are not the main paths'."""
    from repro_torch.optim import ef_compress, ef_init, make_codec

    params = prob.params0
    walls = []
    for mb in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prob.map_compute(params, 0, mb)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    map_ms = statistics.median(walls[1:])
    # the backward's kernel is checked below, so a window that lost its
    # lstm_seq_bwd events is taken again
    for attempt in range(PIPE_TRIES):
        window_ms, busy_ms, n_kernels, by_name, _ = profiled(
            torch, lambda: prob.map_compute(params, 0, 0))
        if launches_named(by_name, "lstm_seq_bwd"):
            break
        print(f"[profile] map window {attempt + 1} of {PIPE_TRIES} recorded "
              f"no lstm_seq_bwd launch; taken again")
    print(f"[profile] one map (B=8, T=40): {map_ms:.3f} ms wall (median of "
          f"5, no profiler); profiled window {window_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / window_ms:.1f}%), "
          f"{n_kernels} kernels")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   {t:.3f} ms in {n} x {name[:90]}")
    seq_ms = per_launch_ms(by_name, "lstm_seq_kernel")
    # the route's backward: lstm_seq_bwd_staged_kernel at the paper's layers
    bwd_ms = per_launch_ms(by_name, "lstm_seq_bwd")
    bwd_names = sorted({re.sub(r"<.*", "", name.split("::")[-1])
                        for name in by_name if "lstm_seq_bwd" in name})
    bwd_map_ms = sum(t for name, (_, t) in by_name.items()
                     if "lstm_seq_bwd" in name)
    print(f"[profile] device time per launch: lstm_seq kernel "
          f"{fmt_ms(seq_ms)}, lstm_seq_bwd kernel {fmt_ms(bwd_ms)} "
          f"({launches_named(by_name, 'lstm_seq_kernel')} / "
          f"{launches_named(by_name, 'lstm_seq_bwd')} launches in the "
          f"map, {bwd_names}; lstm_seq_bwd device ms a map "
          f"{bwd_map_ms:.5f}; lstm_cell kernel launches "
          f"{launches_named(by_name, 'lstm_cell_kernel')})")
    # the wrapper's count holds the launches; the trace holds their kernel
    check(set(bwd_names) == {"lstm_seq_bwd_staged_kernel"},
          f"the map's backward ran {bwd_names}, not the staged kernel")
    map_prof = dict(window_ms=window_ms, busy_ms=busy_ms, kernels=n_kernels,
                    busy_share=busy_ms / window_ms)

    codec = make_codec("ternary")
    grads, _ = prob.map_compute(params, 0, 0)
    residual = ef_init(params)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ef_compress(codec, grads, residual)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    codec_ms = statistics.median(walls[1:])
    reps = 10
    window_ms, busy_ms, n_kernels, by_name, _ = profiled(
        torch, lambda: ef_compress(codec, grads, residual), reps)
    window_ms, busy_ms, n_kernels = (window_ms / reps, busy_ms / reps,
                                     n_kernels / reps)
    scale_ms = per_launch_ms(by_name, "ternary_scale_kernel")
    ef_ms = per_launch_ms(by_name, "ternary_ef_kernel")
    print(f"[profile] one ternary ef_compress of a paper gradient: "
          f"{codec_ms:.4f} ms wall (median of 5, no profiler); profiled "
          f"({reps} in a window) {window_ms:.4f} ms, device busy "
          f"{busy_ms:.4f} ms ({100 * busy_ms / window_ms:.1f}%), "
          f"{n_kernels:g} kernels; device "
          f"time per launch: scale pass {fmt_ms(scale_ms)}, codes + decoded "
          f"+ residual {fmt_ms(ef_ms)}")
    check(ternary_only(by_name) and 0 < n_kernels <= TERNARY_EF_LAUNCHES,
          f"one ternary ef_compress ran {n_kernels:g} kernels, expected "
          f"{TERNARY_EF_LAUNCHES}: {sorted(by_name)}")
    return dict(map_ms=map_ms, seq_ms=seq_ms, bwd_ms=bwd_ms,
                map_profile=map_prof,
                codec_ms=codec_ms, codec_kernels=n_kernels,
                codec_busy_ms=busy_ms, scale_ms=scale_ms, ef_ms=ef_ms)

# ---------------------------------------------------------------------------
# the gateway: real volunteers over TCP and WebSocket, the server's applier
# ---------------------------------------------------------------------------

GATEWAY_VERSIONS = 2          # x 16 mini-batches: 32 updates under staleness
GATEWAY_DRAIN = 16            # staged gradients in one applier drain
GATEWAY_JOIN_S = 300          # bound on any volunteer thread of the phase
GATEWAY_CLI_S = 180           # bound on the CLI server subprocess


def counted(fn, box):
    """``fn`` with each call counted in ``box[0]``."""
    def wrapper(*a, **k):
        box[0] += 1
        return fn(*a, **k)
    return wrapper


def gateway_run(torch, G, prob, policy, specs, n_versions=GATEWAY_VERSIONS):
    """One real-apply ``GatewayServer`` on a thread with a volunteer thread
    per (vid, transport class) of ``specs``; returns (seconds, the final
    model fetched over the wire by the first volunteer, {vid: final
    version}, the server's versions, n_updates)."""
    from repro_torch.core.protocol import FetchModel

    server = G.GatewayServer(prob, n_versions=n_versions, policy=policy,
                             real_apply=True)
    n = server.n_updates
    results, errors, blobs = {}, [], {}

    def drive(vid, cls, first):
        try:
            tr = cls("127.0.0.1", server.port, vid)
            try:
                results[vid] = G.run_volunteer(tr, vid, n, policy=policy,
                                               problem=prob)[0]
                if first:
                    blobs["final"] = tr.call(FetchModel(n)).blob
            finally:
                tr.close()
        except Exception as e:                  # re-raised by the check
            errors.append(repr(e))

    server.start()
    try:
        threads = [threading.Thread(target=drive, args=(vid, cls, i == 0),
                                    daemon=True)
                   for i, (vid, cls) in enumerate(specs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=GATEWAY_JOIN_S)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads),
              f"gateway {policy}: a volunteer did not finish in "
              f"{GATEWAY_JOIN_S} s")
        check(not errors, f"gateway {policy}: volunteer failed: {errors}")
    finally:
        server.close()
    return dt, blobs["final"], results, sorted(server.ds._models), n


def instrumented_gateway(torch, G, prob):
    """The real-apply ``GatewayServer`` over TCP and WebSocket once more,
    one version, with ``ANALYSIS_INSTRUMENT=1`` set before the server and
    the volunteers are built: every gateway lock is a ``MonitoredLock`` of
    the runtime monitor, which holds the static lock graph of the port's
    core (``analysis/locks.py``), and every volunteer park is checked.
    Fails unless ``Analysis.report()`` returns 0 with locks made and static
    edges loaded. Kept apart from the timed runs, which carry no monitor."""
    import contextlib
    import io
    from repro_torch.analysis.runtime import Analysis
    old = os.environ.get("ANALYSIS_INSTRUMENT")
    Analysis.reset()
    os.environ["ANALYSIS_INSTRUMENT"] = "1"
    try:
        mon = Analysis.instrument()
        dt, _, finals, versions, n = gateway_run(
            torch, G, prob, "staleness:2", [("i0", G.SocketTransport),
                                            ("i1", G.WsClientTransport)],
            n_versions=1)
        sink = io.StringIO()
        with contextlib.redirect_stdout(sink):     # its clean line
            rc = mon.report(stream=sink)
        static = len(mon._static)
        found = dict(locks=mon.locks_made, static_edges=static,
                     runtime_edges=len(mon._edges), parks=mon.parks,
                     blocking_sites=mon.blocking_notes,
                     violations=len(mon.violations))
    finally:
        if old is None:
            os.environ.pop("ANALYSIS_INSTRUMENT", None)
        else:
            os.environ["ANALYSIS_INSTRUMENT"] = old
        Analysis.reset()
    print(f"[gateway] instrumented (ANALYSIS_INSTRUMENT=1, staleness:2, TCP + "
          f"WebSocket): {n} updates in {dt:.3f} s, finals {finals}; monitor "
          f"{found}; report() = {rc}: "
          f"{sink.getvalue().strip().splitlines()[-1]!r}")
    check(set(finals.values()) == {n} and versions[-1] == n,
          f"instrumented gateway: finals {finals}, expected {n}")
    check(rc == 0, f"the lock monitor found violations: {sink.getvalue()}")
    check(found["locks"] > 0 and static > 0,
          f"the monitor made {found['locks']} locks and loaded {static} "
          f"static edges")
    return dict(s=dt, updates=n, report=rc, **found)


def phase_gateway(torch, K, T, coord_s):
    """The JSDoop deployment on the card: volunteers join a
    ``GatewayServer`` over real loopback TCP and WebSocket sockets, compute
    real maps at the paper's full width (each through the ``lstm_seq``
    kernel, 2 launches a map), and the server's batched applier commits
    every gradient. Launch counts are set to 0 just before each gateway
    run and read just after; the references (``sequential_async`` /
    ``sequential_local`` on the card) run outside those windows."""
    from repro_torch import tree
    from repro_torch.core import gateway as G
    from repro_torch.core.aggregation import make_policy
    from repro_torch.core.applier import make_real_applier
    from repro_torch.core.dataserver import DataServer
    from repro_torch.core.mapreduce import (TrainingProblem,
                                            sequential_async,
                                            sequential_local)
    from repro_torch.core.protocol import FetchModel, ServerEndpoint, \
        SubmitUpdate
    from repro_torch.core.queue import QueueServer
    from repro_torch.core.tasks import GradResult, INITIAL_QUEUE

    t_phase = time.perf_counter()
    prob = TrainingProblem.paper_problem(seed=0, device="cuda")
    n_params = sum(x.numel() for x in tree.leaves(prob.params0))
    maps = [0]
    prob.map_compute = counted(prob.map_compute, maps)
    out = {"n_params": n_params}

    def held_run(tag, policy, specs, ref):
        maps[0] = 0
        reset_counts(K, T)
        dt, blob, finals, versions, n = gateway_run(torch, G, prob, policy,
                                                    specs)
        seq, cell = K.lstm_seq.launches, K.lstm_cell.launches
        bwd = K.lstm_seq_bwd.launches
        n_maps = maps[0]
        same = None if ref is None else G.same_bits(blob, ref)
        print(f"[gateway] {tag} ({policy}, {len(specs)} volunteer(s): "
              f"{', '.join(c.__name__ for _, c in specs)}): {n} updates in "
              f"{dt:.3f} s ({dt / n * 1e3:.2f} ms an update), finals "
              f"{finals}; {n_maps} maps, lstm_seq launches {seq} "
              f"({prob.seq_launches_per_map} a map), lstm_seq_bwd {bwd}, "
              f"lstm_cell {cell}; "
              f"wire-fetched final model == reference bit for bit: {same}")
        check(set(finals.values()) == {n}, f"{tag}: finals {finals}, "
                                           f"expected {n}")
        check(versions == list(range(versions[0], n + 1)),
              f"{tag}: versions not contiguous: {versions}")
        check(n_maps > 0 and seq == prob.seq_launches_per_map * n_maps,
              f"{tag}: {seq} lstm_seq launches for {n_maps} maps")
        check(bwd == prob.seq_launches_per_map * n_maps,
              f"{tag}: {bwd} lstm_seq_bwd launches for {n_maps} maps")
        check(cell == 0, f"{tag}: {cell} lstm_cell launches")
        check(ref is None or same, f"{tag}: final model differs from the "
                                   f"reference")
        return dict(s=dt, updates=n, maps=n_maps, lstm_seq=seq,
                    lstm_seq_bwd=bwd, lstm_cell=cell, bit_equal=same)

    n_async = GATEWAY_VERSIONS * prob.tp.mini_batches_to_accumulate
    ref_async = sequential_async(prob, n_updates=n_async)[:2]
    ref_local = sequential_local(prob, k=4, n_updates=n_async // 4)[:2]
    out["tcp"] = held_run("tcp", "staleness:2",
                          [("tcp0", G.SocketTransport)], ref_async)
    out["ws"] = held_run("ws", "staleness:2",
                         [("ws0", G.WsClientTransport)], ref_async)
    out["local"] = held_run("local", "local:4",
                            [("tcp0", G.SocketTransport)], ref_local)
    out["race"] = held_run("race", "staleness:2",
                           [("r0", G.SocketTransport),
                            ("r1", G.SocketTransport),
                            ("r2", G.WsClientTransport)], None)

    out["instrumented"] = instrumented_gateway(torch, G, prob)

    # the applier alone: one drain of 16 staged paper gradients (numpy, the
    # form they arrive in off the wire), batched and single, against the
    # chain of apply_one on the card
    grads, (p, s) = [], (prob.params0, prob.opt_state0)
    for i in range(GATEWAY_DRAIN):
        v, mb = prob.stream_slot(i)
        g, _ = prob.map_compute(p, v, mb)
        grads.append(tree.map(lambda t: t.cpu().numpy(), g))
        p, s = prob.apply_one(p, s, g)
    chain = (p, s)

    def drain(batch):
        qs, ds = QueueServer(), DataServer()
        qs.declare(INITIAL_QUEUE, timeout=float("inf"))
        ds.publish_model(0, (prob.params0, prob.opt_state0), nbytes=0)
        ap = make_real_applier(prob, make_policy("staleness:2"), batch=batch)
        ep = ServerEndpoint(qs, ds, applier=ap)
        msgs = []
        for i, g in enumerate(grads):
            qs.publish(INITIAL_QUEUE, "t")
            tag, _ = qs.lease(INITIAL_QUEUE, "w", 0.0)
            msgs.append(SubmitUpdate(INITIAL_QUEUE, tag, GradResult(
                version=i, mb_index=0, payload=g, computed_at=i)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ep.submit_batch(msgs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return ms, ep.handle(FetchModel(GATEWAY_DRAIN)).blob, ap

    applier = {}
    finals = {}
    for batch in (True, False, False, True):
        ms, blob, ap = drain(batch)
        applier.setdefault(batch, []).append(ms)
        finals[batch] = blob
        check(ap.batches == (1 if batch else 0),
              f"applier batch={batch}: {ap.batches} batched drains")
    for _ in range(4):                       # >= 5 timed drains a mode
        for batch in (True, False):
            applier[batch].append(drain(batch)[0])
    same = G.same_bits(finals[True], finals[False]) and \
        G.same_bits(finals[True], chain)
    med = {b: statistics.median(applier[b][1:]) for b in applier}
    print(f"[gateway] applier, one drain of {GATEWAY_DRAIN} paper gradients "
          f"({n_params} parameters): batched {med[True]:.3f} ms, single "
          f"{med[False]:.3f} ms a drain (median of {len(applier[True]) - 1} "
          f"after a warm-up; host clock around a synchronize); batched == "
          f"single == chained apply_one bit for bit: {same}")
    check(same, "batched and single applies differ on the card")
    out["applier_ms"] = {"batched": med[True], "single": med[False],
                         "runs_batched": applier[True],
                         "runs_single": applier[False]}

    # the CLI: a --serve --real-apply server process on the card (the
    # shrunk problem), one volunteer from here
    real = G._real_problem(device="cuda")
    n_cli = 2 * real.tp.mini_batches_to_accumulate
    ref_cli = sequential_async(real, n_updates=n_cli)[:2]
    with tempfile.TemporaryDirectory() as td:
        port_file = os.path.join(td, "gw.port")
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m",
                                 "repro_torch.core.gateway",
                                 "--serve", "--real-apply", "--policy",
                                 "staleness:2", "--n-versions", "2",
                                 "--n-mb", "4", "--port-file", port_file,
                                 "--timeout", str(GATEWAY_CLI_S)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            port = G._wait_port(port_file, proc, timeout=GATEWAY_CLI_S)
            tr = G.SocketTransport("127.0.0.1", port, "cli0")
            try:
                final, _ = G.run_volunteer(tr, "cli0", n_cli,
                                           policy="staleness:2",
                                           problem=real)
                blob = tr.call(FetchModel(n_cli)).blob
            finally:
                tr.close()
            text, _ = proc.communicate(timeout=GATEWAY_CLI_S)
        finally:
            G._reap(proc)
        cli_s = time.perf_counter() - t0
    same = G.same_bits(blob, ref_cli)
    print(f"[gateway] CLI: python -m repro_torch.core.gateway --serve "
          f"--real-apply on the card exited {proc.returncode} in "
          f"{cli_s:.1f} s (limit {GATEWAY_CLI_S} s); final version {final}; "
          f"wire-fetched model == sequential_async bit for bit: {same}; "
          f"server said: {text.strip().splitlines()[-1]!r}")
    check(proc.returncode == 0, f"CLI gateway exited {proc.returncode}: "
                                f"{text[-2000:]}")
    check(final == n_cli and same, "CLI gateway run differs from "
                                   "sequential_async")
    out["cli_s"] = cli_s

    # seconds per update over the gateway against the in-process
    # Coordinator's seconds per version (16 maps + 1 reduce)
    per_update = out["tcp"]["s"] / out["tcp"]["updates"]
    out["s_per_update"] = per_update
    out["s_per_16_updates"] = 16 * per_update
    print(f"[gateway] one TCP volunteer: {per_update:.4f} s an update, "
          f"{16 * per_update:.3f} s per 16 updates; the in-process "
          f"Coordinator: {coord_s:.3f} s a version (16 maps + 1 reduce)")

    # the card's busy share over a few updates through the gateway
    window_ms, busy_ms, n_kernels, by_name, _ = profiled(
        torch, lambda: gateway_run(torch, G, prob, "staleness:2",
                                   [("p0", G.SocketTransport)],
                                   n_versions=1))
    print(f"[gateway] profiled run of 16 updates over TCP: window "
          f"{window_ms:.1f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / window_ms:.2f}%), {n_kernels} kernels, "
          f"lstm_seq {launches_named(by_name, 'lstm_seq_kernel')}")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[gateway]   {t:.3f} ms in {n} x {name[:90]}")
    out["profile"] = dict(window_ms=window_ms, busy_ms=busy_ms,
                          kernels=n_kernels,
                          busy_share=busy_ms / window_ms)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[gateway] phase took {out['phase_s']:.1f} s")
    return out


# the model checker's budget in the analysis phase: a state budget and a
# clock a world (the CLI's defaults are 4,000 states and 12 s)
ANALYSIS_MC = ("--mc-states", "1500", "--mc-seconds", "10")
CHAOS_SEEDS = 2
CHAOS_POLICIES = ("sync", "staleness:2")


def phase_analysis():
    """The port's static passes and model checker over its own control
    plane (``python -m repro_torch.analysis --strict --mc`` at a small
    budget, ``ANALYSIS_MC``), then the chaos harness's sweep (``python -m
    repro_torch.core.chaos``) over ``CHAOS_SEEDS`` seeds under each of
    ``CHAOS_POLICIES``: single-server against sharded SimResults bit for
    bit. Host only; any violation or assertion fails the run."""
    import contextlib
    import io
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.core import chaos
    out = {}
    argv = ["--strict", "--mc", *ANALYSIS_MC]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(argv)
    out["analysis_s"] = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines[-4:]:
        print(f"[analysis] {line}")
    print(f"[analysis] python -m repro_torch.analysis {' '.join(argv)}: exit "
          f"{rc} in {out['analysis_s']:.1f} s")
    check(rc == 0, "the static passes or the model checker found "
                   "violations:\n" + "\n".join(lines[-20:]))
    for policy in CHAOS_POLICIES:
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                chaos.main(seeds=CHAOS_SEEDS, policy=policy)
        except AssertionError as e:
            raise SmokeFailure(f"chaos sweep under {policy} failed: {e!r}")
        out[f"chaos_{policy}_s"] = time.perf_counter() - t0
        runs = buf.getvalue().count("chaos_smoke,")
        print(f"[analysis] python -m repro_torch.core.chaos --seeds "
              f"{CHAOS_SEEDS} --policy {policy}: {runs} metamorphic pairs "
              f"printed in {out[f'chaos_{policy}_s']:.1f} s; "
              f"{buf.getvalue().strip().splitlines()[-1]}")
        check(runs > 0, f"the chaos sweep under {policy} ran nothing")
    return out


# ---------------------------------------------------------------------------
# the dense transformer serving path (qwen1.5-110b at full width, 4 layers)
# ---------------------------------------------------------------------------

# H100 SXM tensor cores, dense bf16 (main sets it from
# repro_torch.launch.mesh.PEAK_FLOPS_BF16)
PEAK_BF16_FLOP_S = None
# ... and dense TF32 (495e12) over the three TF32 products an fp32-accurate
# product takes (the tf32x3 route's split)
PEAK_TF32X3_FLOP_S = 495e12 / 3
HOST_STEP_REPS = 20_000

# tests/test_kernels.py's sweeps; rmsnorm's last two have rows that are not
# 16-byte aligned (the kernel's one-element-at-a-time path)
RMS_SWEEP = [(4, 64), (2, 17, 256), (1, 3, 5, 128), (3, 129), (2, 130)]
FLASH_SWEEP = [(1, 64, 4, 4, 32), (2, 129, 8, 4, 64), (1, 200, 8, 1, 16)]
FLASH_MASKS = [(True, 0), (True, 37), (False, 0)]
FLASH_HD_WIDE = 128        # the sweep's cases again at qwen's head dim
# ... at nemotron-4-340b's 192 (built natively) and at 80 (zero-padded by
# the wrapper, bf16 to 128 and fp32 to 96), both dtypes
FLASH_HD_MORE = (192, 80)
# ... above 192 in both dtypes: 200 (bf16 zero-padded to 256, fp32 to
# 224) and 256 (bf16 on flash_kernel_wgmma<256>), 576 and 1,024 (bf16 on
# the tensor-core column blocks, flash_kernel_wgmma_cols); fp32 on
# flash_kernel_tf32x3 at every width (tf32x3)
FLASH_HD_WIDE_MORE = (200, 256, 576, 1024)
# ... and timed at qwen's prefill shape in both dtypes beside the CUDA-core
# kernel each route replaced (its C function called in the same run), and
# held there at the qwen gate with peaked (x2) inputs at 256 and 576 too
# (fp32: against an fp64 attention); 192 is nemotron-4-340b's width
# (flash_kernel_wgmma<192>); fp32 is timed at qwen's 128 too (phase_flash)
FLASH_HD_TIMED = (192, 256, 576, 1024)
FLASH_HD_PEAKED = (256, 576)
# bf16 at hd 33-192 runs flash_kernel_wgmma_pipe: held at the qwen gate
# at 192, 128 and 64 and zero-padded to them from 160 and 129, 96 and 48,
# over the masks, peaked (x2), lse too, two runs bit-equal, at the built
# widths against flash_kernel_wgmma<HD, 64> too (bit for bit where the
# pipe's warpgroups own that kernel's rows, ``fwd_pipe_bit_equal``), at
# qwen's prefill cut to one batch entry (G = 8: q tiles of 128 folded
# rows, 192 at hd 128), nemotron-4-340b's 96 over 8 heads (G = 12: 120
# rows, 10 whole positions; 192 at hd 128), internvl2-1b's 14 over 2 (G =
# 7: 126 rows, 189 at hd 128) and deepseek-moe-16b's 16 over 16 (G = 1)
FLASH_PIPE_WIDTHS = (192, 160, 129, 128, 96, 64, 48)
FLASH_PIPE_SHAPES = ((1, 1024, 64, 8), (1, 1024, 96, 8), (1, 1024, 14, 2),
                     (1, 1024, 16, 16))
FLASH_PIPE_SCALE = 2.0
# the bf16 forward at hd 64 and 128 (flash_kernel_wgmma_pipe) timed beside
# its yardstick, flash_kernel_wgmma<HD, 64>, at every config's forward
# shape (B, S, H, Kv, hd, causal, with lse): the training microbatches
# (forward with lse, as autograd runs it) and qwen1.5-110b's B=4 prefill
# with lse (the shape the issue's table of losses read), and the serve
# paths' prefills (no lse): deepseek-moe-16b's, jamba-v0.1-52b's attention
# layers, whisper-base's encoder and internvl2-1b's prefill (256 patches +
# 1,024 tokens); FWD_PIPE_FASTER must beat the yardstick's median, every
# other shape stay within its slowest turn
FWD_PIPE_SHAPES = {
    "qwen1.5-110b prefill": (4, 1024, 64, 8, 128, True, True),
    "qwen1.5-110b train": (1, 1024, 64, 8, 128, True, True),
    "stablelm-1.6b train": (1, 4096, 32, 32, 64, True, True),
    "internvl2-1b train": (1, 4096, 14, 2, 64, True, True),
    "deepseek-moe-16b train": (1, 4096, 16, 16, 128, True, True),
    "whisper-base train": (2, 1500, 8, 8, 64, False, True),
    "deepseek-moe-16b serve": (4, 1024, 16, 16, 128, True, False),
    "jamba-v0.1-52b serve": (4, 1024, 32, 8, 128, True, False),
    "whisper-base serve": (4, 1500, 8, 8, 64, False, False),
    "internvl2-1b serve": (4, 1280, 14, 2, 64, True, False)}
FWD_PIPE_FASTER = ("qwen1.5-110b prefill",)
# one call of more than 2^31 elements (2^31 + 2^23 in q), one launch
FLASH_SPLIT = (257, 1024, 64, 8, 128)
# one batch entry of exactly 2^31 elements of q, sliding window 256: the
# last 1,024 rows, whose offsets lie past 2^31, and the first 1,024 held
# against the plain version on a slice that holds every key they see
FLASH_ENTRY = (1, 131072, 128, 16, 128)
FLASH_ENTRY_WINDOW = 256
# a batch past the grid's 65,535 entries a launch: two launches
FLASH_GRID_SPLIT = (70000, 8, 2, 1, 16)
# tests/test_kernels.py::test_flash_attention_sweep (fp32)
FLASH_RTOL, FLASH_ATOL = 5e-5, 5e-6
# at the qwen prefill shape in bf16: both paths compute in fp32 from the same
# bf16 inputs and round once to bf16, so they differ by at most one bf16 ulp
# (<= 2^-7 of |out|, inside the rtol of _tol); the atol is cut from _tol's
# 2e-2 to 5e-4, below the ~3e-3 a dropped 32-key tile moves a long row's
# output (|out| ~ 0.02 there: near-uniform softmax over ~500 values), so
# only rows of tiny output escape the relative bound
QWEN_FLASH_BF16_ATOL = 5e-4
# the qwen prefill shape's inputs: x0.5 (score std 0.25, near-uniform
# softmax, the timed inputs) and x2 (score std 4, peaked: the online
# softmax's running max moves and rescales the accumulator tile after tile)
QWEN_FLASH_SCALES = (0.5, 2.0)
# fp32 at x2 is held against the exact (fp64) attention instead: there one
# ulp of a score near 20 (1.9e-6) moves its probability by as much,
# relative, and |v| up to ~8 carries that to a few 1e-5, above the sweep's
# atol, which was set at unit-size inputs. The kernel must stay within this
# factor of the plain fp32 version's own distance from the exact result; a
# dropped tile or a wrong rescale moves it by orders of magnitude more
QWEN_FLASH_EXACT_FACTOR = 4.0

SERVE_ARCH, SERVE_LAYERS = "qwen1.5-110b", 4            # 80 -> 4 layers
SERVE = dict(requests=8, batch=4, prompt=1024, tokens=16, seed=0)
SERVE_PARAMS = 7_927_349_248
# kernel path against the plain path, same weights, same tokens, on the
# card: max|kernel - plain| over a batch's logits at most this share of its
# max|logit|. The error is noise spread over the whole logit vector, not a
# per-element relative error: in bf16 every rounding of an activation that
# the two paths compute in another order (norm sums, attention sums) moves
# later layers, and two plain versions of the same math (ref.rmsnorm and
# F.rms_norm) differ by as much (~1.2% of max|logit| at 4 layers, printed
# beside every check). bf16: the 2e-2 of tests/test_kernels.py::_tol; fp32
# (the same model in fp32, where the noise is ~1e-5): 1e-4
SERVE_LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SERVE_FP32 = dict(batch=4, prompt=512, tokens=6)
# where the two plain versions of the same bf16 model (ref.rmsnorm and
# F.rms_norm) already lie farther apart than SERVE_LOGIT_TOL of max|logit|,
# the whole path's distance cannot tell a kernel error from rounding noise:
# falcon-mamba-7b's 64 layers of random bf16 weights grow a last-bit
# difference of one norm to ~5% of max|logit|, jamba's 16 to ~2.5% (on an
# H100 80GB HBM3 at 700 W: kernel vs plain 3.02e-1 and 1.68e-1, plain vs
# plain 2.59e-1 and 1.51e-1, max|logit| 5.57 and 5.94). Those phases
# (``hold_logits(gate_path=False)``) print that distance ungated and hold
# each kernel at the model's own shapes and instantiation instead
# (``hold_family_kernels``), the flash kernel alone end to end at
# SERVE_LOGIT_TOL, and the same model in fp32 (SERVE_FP32; jamba cut to one
# period to fit) at SERVE_LOGIT_TOL's 1e-4
# card against CPU at smoke size, fp32: the same math summed in other
# orders (cuBLAS, the kernels' trees) on logits of size ~0.6
SMOKE_LOGIT_TOL = 1e-4


def randn(torch, shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)


def held(torch, name, got, want, rtol, atol) -> float:
    """Max |got - want|; fails unless allclose at (rtol, atol)."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    print(f"[kernel] {name}: max|kernel-plain|={err:.3e} rtol={rtol} "
          f"atol={atol} {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


def exact_causal_attention(torch, q, k, v):
    """Causal GQA attention in fp64 (query head h reads kv head h // G):
    the exact result the fp32 kernel and plain version are measured from."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    qg = q.double().reshape(B, S, Kv, H // Kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.double()) / math.sqrt(hd)
    ok = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.double()) \
        .reshape(B, S, H, hd)


def held_exact(torch, name, got, plain, exact) -> float:
    """Fails unless max|got - exact| is within QWEN_FLASH_EXACT_FACTOR of
    max|plain - exact|. Returns max|got - plain|."""
    torch.cuda.synchronize()
    err = (got.double() - exact).abs().max().item()
    floor = (plain.double() - exact).abs().max().item()
    diff = (got.double() - plain.double()).abs().max().item()
    ok = err <= QWEN_FLASH_EXACT_FACTOR * floor
    print(f"[kernel] {name}: max|kernel-exact|={err:.3e}, max|plain-exact|="
          f"{floor:.3e}, max|kernel-plain|={diff:.3e}; kernel within "
          f"{QWEN_FLASH_EXACT_FACTOR} x plain's distance "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel farther from the exact attention than its "
              f"plain version's rounding")
    return diff


def rms_bound_ms(rows, d, elem_bytes):
    """x read once, y written once, scale read once; ~4 flops an element
    at the fp32 rate."""
    moved = elem_bytes * (2 * rows * d + d)
    t_b, t_o = moved / PEAK_BYTES_S, 4 * rows * d / PEAK_FP32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def flash_bound_ms(B, S, H, Kv, hd, elem_bytes, peak=None, causal=True,
                   products=2):
    """The causal pairs' two products (S(S+1)/2 pairs a head, S^2 without
    the causal mask; 2 flops a multiply-add) at the peak rate of the
    inputs' type (bf16: the tensor
    cores; fp32: the TF32 tensor cores at a third of their rate, each fp32
    product being three TF32 products, PEAK_TF32X3_FLOP_S, the least time
    the card takes for fp32-accurate products; ``peak`` overrides, e.g.
    PEAK_FP32_FLOP_S for the CUDA cores); q, k, v and out each crossed
    once. ``products`` 3 counts the bf16 kernels' P_hi V and P_lo V as two
    products (their own floor, not the function's)."""
    flops = 2 * products * B * H * hd * (S * (S + 1) // 2 if causal
                                         else S * S)
    moved = elem_bytes * (2 * B * S * H * hd + 2 * B * S * Kv * hd)
    if peak is None:
        peak = PEAK_BF16_FLOP_S if elem_bytes == 2 else PEAK_TF32X3_FLOP_S
    t_b, t_o = moved / PEAK_BYTES_S, flops / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def x3_fwd_cols(hd):
    """The output columns a warpgroup of flash_kernel_tf32x3 owns at width
    hd (a multiple of 32), as ``fx3::warp_cols`` in flash_attention.cu sets
    them; a block owns twice as many."""
    return 64 if hd <= 128 else 128 if hd <= 256 else 256


def x3_fwd_work(B, S, H, Kv, hd):
    """A model of what flash_kernel_tf32x3 does in one causal call at width
    hd (a multiple of 32), counted from the shapes and its tiling, not
    measured: (its products over the bound's two, each three TF32
    products; GB requested by TMA; steps of its ring over all blocks). Each
    of its n_cb column blocks forms S over the full width again and adds
    P V over its columns, on every visited 64 x 64 tile pair (the
    diagonal's whole), and requests for each pair q's and k's 64 rows over
    the full width and v's over its columns, in ceil(hd / 64) product
    steps and one output step per 64 columns of its first warpgroup."""
    wc = x3_fwd_cols(hd)
    n_cb = -(-hd // (2 * wc))
    n_t = -(-S // 64)
    pairs = B * H * n_t * (n_t + 1) // 2       # visited tile pairs
    exact = B * H * S * (S + 1) // 2 / (pairs * 64 * 64)
    moved = pairs * 64 * 4 * (2 * hd * n_cb + hd)
    steps = pairs * sum(-(-hd // 64) + -(-min(wc, hd - 2 * wc * cb) // 64)
                        for cb in range(n_cb))
    return (n_cb + 1) / 2 / exact, moved / 1e9, steps


def fwd_registers(FA, hd):
    """ptxas's registers and spills of flash_kernel_tf32x3 at width hd (the
    instance of its warpgroup's columns, ``x3_fwd_cols``)."""
    from repro_torch.kernels import build as kbuild
    report = ptxas_report(kbuild.log_path(FA.SOURCE).read_text())
    return {name: rep for name, rep in report
            if f"tf32x3<Li{x3_fwd_cols(hd)}>" in name}


def pipe_registers(FA, source=None):
    """ptxas's registers and spills of each instance of
    flash_kernel_wgmma_pipe (bf16 at hd 33-192; named with its width and
    warpgroups, as the profiler names it), or with ``source`` FA.BWD_SOURCE
    of the backward's two-warpgroup kernels (flash_bwd_dq_wgmma_pipe and
    flash_bwd_dkdv_wgmma_pipe at hd 64 and 128)."""
    from repro_torch.kernels import build as kbuild
    report = ptxas_report(kbuild.log_path(source or FA.SOURCE).read_text(),
                          all_args=source is None)
    return {name: rep for name, rep in report if "wgmma_pipe" in name}


# the widths flash_kernel_wgmma_pipe is built at (bf16; the wrapper pads
# hd 33-63 to 64, 65-127 to 128 and 129-191 to 192)
FWD_PIPE_DIMS = (64, 128, 192)


def fwd_pipe_warpgroups(hd):
    """The warpgroups of flash_kernel_wgmma_pipe at width hd (64, 128 or
    192): three at 128, else two."""
    return 3 if hd == 128 else 2


def fwd_pipe_instance(hd):
    """The profiler's name of flash_kernel_wgmma_pipe's instance at width
    hd, with its warpgroups."""
    return f"flash_kernel_wgmma_pipe<{hd}, {fwd_pipe_warpgroups(hd)}>"


def fwd_pipe_kernel(hd, G):
    """The profiler's name of the bf16 forward kernel the route runs at
    width hd (64, 128 or 192) with G query heads a kv head, as
    flash_attention.cu's ``tc::launch`` picks it: flash_kernel_wgmma_pipe
    with its warpgroups, but flash_kernel_wgmma<128, 64> at hd 128 with G
    = 1 (``pipe_at_128``)."""
    if hd == 128 and G == 1:
        return "flash_kernel_wgmma<128, 64>"
    return fwd_pipe_instance(hd)


def fwd_pipe_bit_equal(hd, G):
    """Whether the route's forward at (hd, G) sums every row as its
    yardstick flash_kernel_wgmma<hd, 64> does, bit for bit: where it runs
    that kernel, and where G divides flash_kernel_wgmma_pipe's block rows
    (64 a warpgroup), so that each warpgroup owns the same 64 rows in both
    and each kv tile takes the same scaling (the source's header note)."""
    return fwd_pipe_kernel(hd, G).startswith("flash_kernel_wgmma<") or \
        64 * fwd_pipe_warpgroups(hd) % G == 0


def fwd_name(name):
    """The flash forward kernel a profiler's kernel name holds, with its
    template arguments (``flash_kernel_wgmma_pipe<128, 3>``), or None."""
    m = re.search(r"flash_kernel\w*(?:<[\w, ]+>)?", name)
    return m.group(0) if m else None


def fwd_kernels(by_name):
    """{forward kernel: launches} of a profiled window."""
    out = {}
    for name, (n, _) in by_name.items():
        if fwd_name(name):
            out[fwd_name(name)] = out.get(fwd_name(name), 0) + n
    return out


def check_fwd_kernels(tag, by_name, want):
    """Fails unless the profiled window ran exactly the forward kernels
    ``want`` ({name: launches}); returns what it ran."""
    got = fwd_kernels(by_name)
    print(f"[profile] {tag}: flash forward kernels {got or 'none'} "
          f"(expected {want or 'none'}) {'ok' if got == want else 'FAIL'}")
    check(got == want, f"{tag}: the flash forward ran {got}, not {want}")
    return got


def ptxas_report(log, all_args=False):
    """[(kernel, "spills, registers")] from an ``-Xptxas -v`` log, each
    kernel named with its first mangled template argument (``fLi192``:
    float, hd 192), or with ``all_args`` with all its integer ones as the
    profiler writes them (``flash_kernel_wgmma_pipe<128, 3>``)."""
    out = []
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            m = re.search(r"\d+((?:lstm|flash|rmsnorm|ternary)[a-z0-9_]*)"
                          r"(I\w*?E)?", hit.group(1))
            name = (m.group(1) + (f"<{m.group(2)[1:-1]}>" if m.group(2)
                                  else "")) if m else hit.group(1)
            full = re.search(r"\d+((?:flash)[a-z0-9_]*)I((?:Li\d+E)+)E",
                             hit.group(1))
            if all_args and full:
                name = f"{full.group(1)}<" + ", ".join(
                    re.findall(r"Li(\d+)E", full.group(2))) + ">"
            out.append([name, {}])
        elif out and ("registers" in line or "spill" in line):
            out[-1][1][line.split(":", 1)[-1].strip()] = None
    return [(name, ", ".join(parts)) for name, parts in out]


def hgmma_count(source):
    """HGMMA (Hopper tensor-core) instructions in a built library's SASS,
    read with cuobjdump; None where the toolkit has no cuobjdump."""
    import shutil
    from repro_torch.kernels import build as kbuild
    tool = shutil.which("cuobjdump") or str(pathlib.Path(kbuild.nvcc())
                                             .parent / "cuobjdump")
    if not pathlib.Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(kbuild.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    return len(re.findall(r"\sHGMMA\.", sass))


def rms_host_steps(torch, RN, x, s):
    """Host microseconds of each step of one ``rmsnorm`` call at x's shape,
    each step alone in a loop, beside the whole call and ``F.rms_norm``: the
    wrapper's cost is host time when the device work is a few microseconds.
    """
    import torch.nn.functional as F
    from repro_torch.kernels import build as kbuild
    fn = RN.build()[x.dtype]
    y = torch.empty_like(x)
    xp, sp, yp = x.data_ptr(), s.data_ptr(), y.data_ptr()
    dev = x.get_device()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def in_context():
        with torch.cuda.device(dev):
            pass

    # the whole call, each step of it, and beside them the steps that the
    # lean path replaced (torch.empty_like with deterministic mode's NaN
    # fill, the device context, current_stream) and the library call
    steps = {
        "whole call": lambda: RN.rmsnorm(x, s),
        "checks": lambda: RN._check(x, s),
        "bind": lambda: RN.build()[x.dtype],
        "output (no fill)": lambda: kbuild.empty_like(x),
        "alignment": lambda: (xp | sp | yp) % 16,
        "current device test": lambda: dev == torch.cuda.current_device(),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev),
        "C call and launch": lambda: fn(xp, sp, yp, x.shape[0], x.shape[1],
                                        1e-6, 1, stream),
        "was: torch.empty_like": lambda: torch.empty_like(x),
        "was: torch.cuda.device context": in_context,
        "was: current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "F.rms_norm": lambda: F.rms_norm(x, (x.shape[-1],), s, 1e-6),
    }
    before = RN.rmsnorm.launches
    us = {}
    for name, step in steps.items():
        for _ in range(200):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_STEP_REPS):
            step()
        us[name] = (time.perf_counter() - t0) / HOST_STEP_REPS * 1e6
        torch.cuda.synchronize()
    RN.rmsnorm.launches = before          # timing calls are not the path's
    print(f"[host] rmsnorm wrapper steps at {list(x.shape)} "
          f"{str(x.dtype).split('.')[-1]}, us per call: " +
          ", ".join(f"{k} {v:.3f}" for k, v in us.items()))
    return us


def phase_rmsnorm(torch, RN, ref):
    """rmsnorm against its plain version over the JAX sweep and the serve
    path's shapes; times at those shapes beside the plain version,
    ``F.rms_norm`` and the bound."""
    import torch.nn.functional as F
    for i, shape in enumerate(RMS_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = randn(torch, shape, dtype, seed=i)
            s = randn(torch, shape[-1:], dtype, seed=100 + i)
            held(torch, f"rmsnorm {shape} {name}", RN.rmsnorm(x, s),
                 ref.rmsnorm(x, s), TOL[name], TOL[name])
    rows = {}
    worst = 0.0
    d = 8192
    for key, n_rows in (("prefill", SERVE["batch"] * SERVE["prompt"]),
                        ("decode", SERVE["batch"])):
        x = randn(torch, (n_rows, d), torch.bfloat16, seed=7)
        s = randn(torch, (d,), torch.bfloat16, seed=8)
        worst = max(worst, held(torch, f"rmsnorm qwen {key} [{n_rows}, {d}] "
                                f"bfloat16", RN.rmsnorm(x, s),
                                ref.rmsnorm(x, s), TOL["bfloat16"],
                                TOL["bfloat16"]))
        ms = median_ms(lambda: RN.rmsnorm(x, s), torch)
        plain_ms = median_ms(lambda: ref.rmsnorm(x, s), torch)
        lib_ms = median_ms(lambda: F.rms_norm(x, (d,), s, 1e-6), torch)
        bound, by = rms_bound_ms(n_rows, d, 2)
        print(f"[kernel] rmsnorm time [{n_rows}, {d}] bf16: kernel "
              f"{ms:.5f} ms, plain {plain_ms:.5f} ms, F.rms_norm "
              f"{lib_ms:.5f} ms, bound {bound:.6f} ms ({by})")
        rows[key] = dict(shape=[n_rows, d], ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by)
        if key == "decode":
            rows[key]["host_us"] = rms_host_steps(torch, RN, x, s)
    return worst, rows


def sdpa(torch, q, k, v, causal=True):
    """The one-call PyTorch operator on q [B,S,H,hd], k/v [B,S,Kv,hd]
    (GQA, causal unless told), for comparison only."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True).transpose(1, 2)


def sdpa_backend(torch, fn) -> str:
    """The implementation SDPA dispatched ``fn`` to, read from the
    profiler's op names (``aten::_scaled_dot_product_flash_attention``,
    ``..._efficient_attention``, ``..._cudnn_attention``,
    ``..._attention_math``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.key.startswith("aten::_scaled_dot_product_")})
    for tag in ("flash", "efficient", "cudnn", "math"):
        if any(tag in n for n in names):
            return tag
    return "unknown (" + ", ".join(names) + ")"


def phase_flash(torch, FA, ref):
    """flash_attention against its plain version over the JAX sweep (fp32
    at the sweep's tolerance, bf16 at _tol) and at the qwen prefill shape
    (bf16 at _tol's rtol and QWEN_FLASH_BF16_ATOL; fp32 at the sweep's
    tolerance, and with a peaked softmax against the exact attention);
    times there beside the plain version, SDPA and the bound."""
    for i, (B, S, H, Kv, hd) in enumerate(FLASH_SWEEP):
        for causal, window in FLASH_MASKS:
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[-1]
                q, k, v = (randn(torch, (B, S, n, hd), dtype, 10 * i + j, 0.5)
                           for j, n in enumerate((H, Kv, Kv)))
                rtol, atol = (FLASH_RTOL, FLASH_ATOL) if name == "float32" \
                    else (TOL[name], TOL[name])
                held(torch, f"flash_attention B={B} S={S} H={H} Kv={Kv} "
                     f"hd={hd} causal={causal} window={window} {name}",
                     FA.flash_attention(q, k, v, causal=causal, window=window),
                     ref.flash_attention(q, k, v, causal=causal,
                                         window=window), rtol, atol)
            # the same folds and masks at qwen's head width, in bf16 (the
            # tensor-core kernel's two-box rows)
            q, k, v = (randn(torch, (B, S, n, FLASH_HD_WIDE),
                             torch.bfloat16, 10 * i + j, 0.5)
                       for j, n in enumerate((H, Kv, Kv)))
            held(torch, f"flash_attention B={B} S={S} H={H} Kv={Kv} "
                 f"hd={FLASH_HD_WIDE} causal={causal} window={window} "
                 f"bfloat16", FA.flash_attention(q, k, v, causal=causal,
                                                 window=window),
                 ref.flash_attention(q, k, v, causal=causal, window=window),
                 TOL["bfloat16"], TOL["bfloat16"])
            # hd 192 (built natively: three 64-column boxes, m64n192k16) and
            # a width padded to the next built one, in both dtypes
            for hd_x in FLASH_HD_MORE:
                for dtype in (torch.float32, torch.bfloat16):
                    name = str(dtype).split(".")[-1]
                    q, k, v = (randn(torch, (B, S, n, hd_x), dtype,
                                     10 * i + j, 0.5)
                               for j, n in enumerate((H, Kv, Kv)))
                    rtol, atol = (FLASH_RTOL, FLASH_ATOL) \
                        if name == "float32" else (TOL[name], TOL[name])
                    held(torch, f"flash_attention B={B} S={S} H={H} Kv={Kv} "
                         f"hd={hd_x} causal={causal} window={window} {name}",
                         FA.flash_attention(q, k, v, causal=causal,
                                            window=window),
                         ref.flash_attention(q, k, v, causal=causal,
                                             window=window), rtol, atol)
            # widths above 192 in both dtypes (bf16 on the wide tensor-core
            # routes, fp32 on tf32x3), causal with and without a window
            if not causal:
                continue
            for hd_x in FLASH_HD_WIDE_MORE:
                for dtype in (torch.float32, torch.bfloat16):
                    name = str(dtype).split(".")[-1]
                    q, k, v = (randn(torch, (B, S, n, hd_x), dtype,
                                     10 * i + j, 0.5)
                               for j, n in enumerate((H, Kv, Kv)))
                    rtol, atol = (FLASH_RTOL, FLASH_ATOL) \
                        if name == "float32" else (TOL[name], TOL[name])
                    held(torch, f"flash_attention B={B} S={S} H={H} Kv={Kv} "
                         f"hd={hd_x} causal={causal} window={window} {name} "
                         f"({FA.route(dtype, hd_x, S, H // Kv)})",
                         FA.flash_attention(q, k, v, causal=causal,
                                            window=window),
                         ref.flash_attention(q, k, v, causal=causal,
                                             window=window), rtol, atol)
    # every route the sweep's sizes reach was taken; the CUDA-core kernels
    # (bf16 only past 2^31 - 256 folded rows) are held through their C
    # functions in flash_wide_times
    reach = {FA.route(dtype, hd_x, S, H // Kv)
             for B, S, H, Kv, hd in FLASH_SWEEP
             for dtype in (torch.float32, torch.bfloat16)
             for hd_x in (hd, FLASH_HD_WIDE, *FLASH_HD_MORE,
                          *FLASH_HD_WIDE_MORE)}
    print(f"[kernel] flash_attention sweep launches by route "
          f"{FA.flash_attention.route_launches} (reachable at these sizes: "
          f"{sorted(reach)}), of them on padded inputs "
          f"{FA.flash_attention.padded_launches}")
    check(all(FA.flash_attention.route_launches[r] > 0 for r in reach),
          f"a flash route the sweep reaches was never taken: "
          f"{FA.flash_attention.route_launches}")
    B, S, H, Kv, hd = SERVE["batch"], SERVE["prompt"], 64, 8, 128
    worst = 0.0
    for scale in QWEN_FLASH_SCALES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v = (randn(torch, (B, S, n, hd), dtype, 50 + j, scale)
                       for j, n in enumerate((H, Kv, Kv)))
            tag = (f"flash_attention qwen prefill B={B} S={S} H={H} "
                   f"Kv={Kv} hd={hd} causal inputs x{scale} {name}")
            if name == "float32" and scale > 1:
                held_exact(torch, tag, FA.flash_attention(q, k, v),
                           ref.flash_attention(q, k, v),
                           exact_causal_attention(torch, q, k, v))
                continue
            rtol, atol = (FLASH_RTOL, FLASH_ATOL) if name == "float32" \
                else (TOL[name], QWEN_FLASH_BF16_ATOL)
            err = held(torch, tag, FA.flash_attention(q, k, v),
                       ref.flash_attention(q, k, v), rtol, atol)
            if name == "bfloat16":
                worst = max(worst, err)
    q, k, v = (randn(torch, (B, S, n, hd), torch.bfloat16, 50 + j,
                     QWEN_FLASH_SCALES[0]) for j, n in enumerate((H, Kv, Kv)))
    ms = median_ms(lambda: FA.flash_attention(q, k, v), torch, reps=10,
                   inner=3)
    plain_ms = median_ms(lambda: ref.flash_attention(q, k, v), torch,
                         reps=10, inner=3)
    # SDPA picks kernels that deterministic mode may refuse: off for it only
    torch.use_deterministic_algorithms(False)
    try:
        lib = sdpa(torch, q, k, v)
        lib_err = (lib().float() - ref.flash_attention(q, k, v).float()) \
            .abs().max().item()
        lib_ms = median_ms(lib, torch, reps=10, inner=3)
    finally:
        torch.use_deterministic_algorithms(True)
    del q, k, v
    # fp32 at qwen's own width (tf32x3) beside the CUDA-core kernel it
    # replaced and SDPA in fp32; then the wider widths in both dtypes
    fp32 = flash_wide_times(torch, FA, ref, B, S, H, Kv, hd,
                            dtypes=(torch.float32,))["float32"]
    wide = {f"hd{w}": flash_wide_times(torch, FA, ref, B, S, H, Kv, w)
            for w in FLASH_HD_TIMED}
    pipe_err, pipe_lse_err, pipe_same = flash_pipe_gate(torch, FA, ref)
    bound, by = flash_bound_ms(B, S, H, Kv, hd, 2)
    print(f"[kernel] flash_attention time B={B} S={S} H={H} Kv={Kv} "
          f"hd={hd} causal bf16 (tensor-core kernel): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (max|SDPA-plain| "
          f"{lib_err:.3e}), bound {bound:.5f} ms ({by}); fp32 (tf32x3) "
          f"{fp32['ms']:.4f} ms, SDPA in fp32 {fp32['library_ms']:.4f} ms")
    return worst, dict(shape=[B, S, H, Kv, hd], ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by,
                       hd128={"float32": fp32},
                       pipe_gate=dict(max_abs_err=pipe_err,
                                      lse_err=pipe_lse_err,
                                      bit_equal_to_yardstick=pipe_same),
                       **wide)


def c_call(torch, FA, key, q, k, v, with_lse=False, causal=True, window=0):
    """The forward C function bound as ``FA._FNS[q.dtype, key]``, called
    directly at q's width (causal by default), for comparison and timing
    beside the route that replaced its kernel; out, and lse too
    ``with_lse``."""
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device) \
        if with_lse else None
    err = FA.build()[q.dtype, key](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, H, k.shape[2], hd,
        int(causal), window, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"{FA._FNS[q.dtype, key]} launch failed: {err}")
    return (out, lse) if with_lse else out


def cuda_core(torch, FA, q, k, v):
    """The CUDA-core kernel of q's dtype (``flash_attention_f32`` /
    ``flash_attention_bf16_cc``: flash_kernel at the built widths,
    flash_kernel_chunked at any other), through its C function."""
    return c_call(torch, FA, "cuda_core", q, k, v)


def fwd_yardstick(torch, FA, q, k, v, with_lse=False, causal=True,
                  window=0):
    """flash_kernel_wgmma<HD, 64>, which bf16 ran on at hd 33-192 before
    flash_kernel_wgmma_pipe, through its own C function
    (``flash_attention_bf16_yardstick``, hd 64, 128 and 192 only): the
    yardstick."""
    check(q.shape[-1] in FA.YARDSTICK_DIMS,
          f"the forward yardstick takes hd {FA.YARDSTICK_DIMS}")
    return c_call(torch, FA, "wgmma_yardstick", q, k, v, with_lse, causal,
                  window)


def flash_wide_times(torch, FA, ref, B, S, H, Kv, hd, dtypes=None):
    """Per-call times at head width hd in each of ``dtypes`` (both by
    default) beside the plain version, SDPA in the same dtype (and the
    backend SDPA picked), the bound and the CUDA-core kernel the route
    replaced (its C function called here, held to the plain version too),
    which must be slower; bf16 above 256 and fp32 from 256 must be faster
    than SDPA too. Each held to its plain version first, at the qwen gate
    (bf16) or the sweep's tolerance (fp32), two runs bit-equal, and at
    FLASH_HD_PEAKED also with x2 inputs (fp32: within
    QWEN_FLASH_EXACT_FACTOR of the plain version's distance from an fp64
    attention). For fp32 it also prints the bound at the CUDA cores' rate
    and the model of products and bytes (``x3_fwd_work``), and adds
    ptxas's registers to the row."""
    out = {}
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        path = FA.route(dtype, hd, S, H // Kv)
        q, k, v = (randn(torch, (B, S, n, hd), dtype, 80 + j, 0.5)
                   for j, n in enumerate((H, Kv, Kv)))
        rtol, atol = (FLASH_RTOL, FLASH_ATOL) if name == "float32" \
            else (TOL[name], QWEN_FLASH_BF16_ATOL)
        plain = ref.flash_attention(q, k, v)
        got = FA.flash_attention(q, k, v)
        err = held(torch, f"flash_attention B={B} S={S} H={H} Kv={Kv} "
                   f"hd={hd} causal {name} ({path})", got, plain, rtol, atol)
        again = FA.flash_attention(q, k, v)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        check(same, f"hd {hd} {name}: two runs of {path} differ")
        del got, again
        reps, inner = (5, 2) if hd <= 256 else (3, 1)
        ms = median_ms(lambda: FA.flash_attention(q, k, v), torch, reps=reps,
                       inner=inner, warm=3)
        plain_ms = median_ms(lambda: ref.flash_attention(q, k, v), torch,
                             reps=3, inner=1, warm=2)
        torch.use_deterministic_algorithms(False)
        try:
            lib = sdpa(torch, q, k, v)
            backend = sdpa_backend(torch, lib)
            lib_ms = median_ms(lib, torch, reps=reps, inner=inner, warm=3)
        finally:
            torch.use_deterministic_algorithms(True)
        bound, by = flash_bound_ms(B, S, H, Kv, hd, q.element_size())
        cc_name = FA._FNS[dtype, "cuda_core"]
        err_cc = held(torch, f"{cc_name} B={B} S={S} H={H} Kv={Kv} hd={hd} "
                      f"causal {name} (the CUDA-core kernel replaced)",
                      cuda_core(torch, FA, q, k, v), plain, rtol, atol)
        cc_ms = median_ms(lambda: cuda_core(torch, FA, q, k, v), torch,
                          reps=3, inner=1, warm=1)
        check(ms < cc_ms, f"hd {hd} {name}: {path} ({ms:.4f} ms) is not "
                          f"faster than the CUDA-core kernel it replaced "
                          f"({cc_ms:.4f} ms)")
        yard = {}
        if name == "bfloat16" and hd == 192:
            # flash_kernel_wgmma_pipe beside the kernel it replaced, timed
            # in turns
            yard["yardstick_err"] = held(
                torch, f"flash_kernel_wgmma<192, 64> B={B} S={S} H={H} "
                f"Kv={Kv} hd={hd} causal bfloat16 (the yardstick)",
                fwd_yardstick(torch, FA, q, k, v), plain, rtol, atol)
            turns = [median_ms(fn, torch, reps=reps, inner=inner, warm=3)
                     for fn in (lambda: fwd_yardstick(torch, FA, q, k, v),
                                lambda: FA.flash_attention(q, k, v))]
            yard["yardstick_ms"], ms = turns
            check(ms < yard["yardstick_ms"],
                  f"hd 192 bf16: flash_kernel_wgmma_pipe ({ms:.4f} ms) is "
                  f"not faster than flash_kernel_wgmma<192, 64> "
                  f"({yard['yardstick_ms']:.4f} ms)")
            yard["registers"] = pipe_registers(FA)
        if hd > 256 or (name == "float32" and hd >= 256):
            check(ms < lib_ms, f"hd {hd} {name}: {path} ({ms:.4f} ms) is not "
                               f"faster than SDPA ({backend}, {lib_ms:.4f} "
                               f"ms)")
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   library_backend=backend, bound_ms=bound, bound_by=by,
                   max_abs_err=err, route=path, bit_equal=same,
                   cuda_core_ms=cc_ms, cuda_core_err=err_cc, **yard)
        more = "" if not yard else (
            f"; flash_kernel_wgmma<192, 64> {yard['yardstick_ms']:.4f} ms "
            f"(it / the kernel {yard['yardstick_ms'] / ms:.2f}); ptxas: "
            f"{'; '.join(f'{n} {r}' for n, r in yard['registers'].items())}")
        if name == "float32":
            bound_cc, _ = flash_bound_ms(B, S, H, Kv, hd, 4,
                                         PEAK_FP32_FLOP_S)
            work, gb, steps = x3_fwd_work(B, S, H, Kv,
                                          FA.native_head_dim(hd))
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            regs = fwd_registers(FA, FA.native_head_dim(hd))
            # the model's numbers and the CUDA cores' bound go to the log
            # only: every number of the kernels line is measured
            row["registers"] = regs
            more = (f"; bound at the CUDA cores' 67 TFLOP/s {bound_cc:.4f} "
                    f"ms; {work:.3f}x the bound's products (each three TF32 "
                    f"products), {gb:.2f} GB requested by TMA (a model: "
                    f"{gb / ms:.2f} TB/s), {steps:,} ring steps (a model: "
                    f"{ms * 1e3 / (steps / sms):.3f} us a step on each of "
                    f"{sms} SMs); ptxas: "
                    f"{'; '.join(f'{n} {r}' for n, r in regs.items())}")
        if hd in FLASH_HD_PEAKED:
            del plain
            q, k, v = (randn(torch, (B, S, n, hd), dtype, 90 + j, 2.0)
                       for j, n in enumerate((H, Kv, Kv)))
            tag = (f"flash_attention B={B} S={S} H={H} Kv={Kv} hd={hd} "
                   f"causal inputs x2 {name} ({path})")
            if name == "float32":
                row["max_abs_err_x2"] = held_exact(
                    torch, tag, FA.flash_attention(q, k, v),
                    ref.flash_attention(q, k, v),
                    exact_causal_attention(torch, q, k, v))
            else:
                row["max_abs_err_x2"] = held(
                    torch, tag, FA.flash_attention(q, k, v),
                    ref.flash_attention(q, k, v), rtol, atol)
        print(f"[kernel] flash_attention time B={B} S={S} H={H} Kv={Kv} "
              f"hd={hd} causal {name} ({path}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ({backend} backend), "
              f"the CUDA-core kernel it replaced {cc_ms:.4f} ms, bound "
              f"{bound:.5f} ms ({by}); kernel / bound {ms / bound:.2f}, "
              f"kernel / SDPA {ms / lib_ms:.2f}, CUDA-core kernel / kernel "
              f"{cc_ms / ms:.2f}; two runs bit-equal {same}{more}")
        out[name] = row
        del q, k, v
        torch.cuda.empty_cache()
    return out


def flash_pipe_gate(torch, FA, ref):
    """flash_kernel_wgmma_pipe (bf16, hd 33-192) against the plain version
    at FLASH_PIPE_WIDTHS x FLASH_PIPE_SHAPES x the masks, inputs x2: out at
    the qwen gate, lse within TRAIN_LSE_TOL, two runs bit-equal, every
    launch on ``wgmma`` (the widths between the built ones counted as
    padded); at the built widths its yardstick flash_kernel_wgmma<HD, 64>
    (``fwd_yardstick``) at the qwen gate too, and bit for bit equal to the
    route's output where ``fwd_pipe_bit_equal``. Returns the worst
    max|kernel - plain| of out and of lse and the cases held bit-equal to
    the yardstick."""
    worst, worst_lse = 0.0, 0.0
    rtol, atol = TOL["bfloat16"], QWEN_FLASH_BF16_ATOL
    lrtol, latol = TRAIN_LSE_TOL
    before = (FA.flash_attention.route_launches["wgmma"],
              FA.flash_attention.padded_launches)
    n = padded = same_as_yard = 0
    for hd in FLASH_PIPE_WIDTHS:
        wide = FA.native_head_dim(hd, torch.bfloat16)
        check(wide in FWD_PIPE_DIMS, f"hd {hd} bf16 runs at {wide}, not at "
                                     f"a width of the pipe kernel")
        for B, S, H, Kv in FLASH_PIPE_SHAPES:
            G = H // Kv
            q, k, v = (randn(torch, (B, S, m, hd), torch.bfloat16, 300 + j,
                             FLASH_PIPE_SCALE)
                       for j, m in enumerate((H, Kv, Kv)))
            for causal, window in FLASH_MASKS:
                tag = (f"flash_attention B={B} S={S} H={H} Kv={Kv} hd={hd} "
                       f"causal={causal} window={window} inputs "
                       f"x{FLASH_PIPE_SCALE} bfloat16 (wgmma, "
                       f"{fwd_pipe_kernel(wide, G)})")
                got, lse = FA.flash_attention(q, k, v, causal=causal,
                                              window=window, with_lse=True)
                again = FA.flash_attention(q, k, v, causal=causal,
                                           window=window)
                n += 2
                padded += 2 * (wide != hd)
                want, plse = ref.flash_attention(q, k, v, causal=causal,
                                                 window=window, with_lse=True)
                worst = max(worst, held(torch, tag, got, want, rtol, atol))
                lse_err = (lse - plse).abs().max().item()
                check(bool(((lse - plse).abs() <=
                            lrtol * plse.abs() + latol).all()),
                      f"{tag}: lse off by {lse_err:.3e}")
                check(torch.equal(got, again), f"{tag}: two runs differ")
                worst_lse = max(worst_lse, lse_err)
                if wide == hd:
                    yard, ylse = fwd_yardstick(torch, FA, q, k, v, True,
                                               causal, window)
                    held(torch, f"{tag}: flash_kernel_wgmma<{hd}, 64> (the "
                         f"yardstick)", yard, want, rtol, atol)
                    if fwd_pipe_bit_equal(hd, G):
                        check(torch.equal(got, yard) and
                              torch.equal(lse, ylse),
                              f"{tag}: not bit-equal to its yardstick")
                        same_as_yard += 1
                    del yard, ylse
            del q, k, v, got, again, want, lse, plse
    got_n = (FA.flash_attention.route_launches["wgmma"] - before[0],
             FA.flash_attention.padded_launches - before[1])
    check(got_n == (n, padded), f"hd 33-192 launches (wgmma, padded) "
                                f"{got_n}, expected {(n, padded)}")
    print(f"[kernel] flash_kernel_wgmma_pipe over hd {FLASH_PIPE_WIDTHS} x "
          f"{len(FLASH_PIPE_SHAPES)} shapes x {len(FLASH_MASKS)} masks, "
          f"inputs x{FLASH_PIPE_SCALE}: worst max|kernel-plain| {worst:.3e} "
          f"(out), {worst_lse:.3e} (lse); two runs bit-equal; {n} launches "
          f"on wgmma, {padded} padded; out and lse bit-equal to "
          f"flash_kernel_wgmma<HD, 64> in {same_as_yard} cases (where G "
          f"divides the block's rows)")
    torch.cuda.empty_cache()
    return worst, worst_lse, same_as_yard


def phase_flash_split(torch, FA, ref):
    """Calls of 2^31 elements or more: one bf16 call of more than 2^31
    elements over batch (FLASH_SPLIT, ~10 GB) in one launch, entries at
    both ends and in the middle held bit for bit against the kernel run on
    that entry alone and against the plain version at the qwen gate; one
    batch entry of exactly 2^31 elements (FLASH_ENTRY, window 256) in bf16
    and fp32, its first and last 1,024 rows held against the plain version
    on slices holding every key they see; and a batch past the grid's
    65,535 entries (FLASH_GRID_SPLIT), two launches, entries bit for bit
    against the kernel alone. Returns the launches of each."""
    launches = {}
    B, S, H, Kv, hd = FLASH_SPLIT
    q, k, v = (randn(torch, (B, S, n, hd), torch.bfloat16, 60 + j, 0.5)
               for j, n in enumerate((H, Kv, Kv)))
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    n = launches["over_batch"] = FA.flash_attention.launches - before
    print(f"[kernel] flash_attention B={B} S={S} H={H} Kv={Kv} hd={hd} "
          f"causal bf16: {q.numel():,} elements of q (2^31 = {2 ** 31:,}), "
          f"{n} launch(es)")
    check(q.numel() >= 2 ** 31 and n == 1,
          f"the call of {q.numel()} elements made {n} launches, expected 1")
    for b in sorted({0, 1, B // 2, B - 1}):
        one = (t[b:b + 1].contiguous() for t in (q, k, v))
        alone = FA.flash_attention(*one)
        torch.cuda.synchronize()
        same = torch.equal(out[b:b + 1], alone)
        print(f"[kernel] call over 2^31 elements, batch entry {b}: bit-equal "
              f"to the kernel on that entry alone: {same}")
        check(same, f"batch entry {b} of the call differs from the kernel "
                    f"run on it alone")
        held(torch, f"call over 2^31 elements, batch entry {b} vs plain",
             out[b:b + 1], ref.flash_attention(q[b:b + 1], k[b:b + 1],
                                               v[b:b + 1]),
             TOL["bfloat16"], QWEN_FLASH_BF16_ATOL)
    del q, k, v, out, one, alone
    torch.cuda.empty_cache()

    B, S, H, Kv, hd = FLASH_ENTRY
    w, rows = FLASH_ENTRY_WINDOW, 1024
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        q, k, v = (randn(torch, (B, S, n, hd), dtype, 90 + j, 0.5)
                   for j, n in enumerate((H, Kv, Kv)))
        before = FA.flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = FA.flash_attention(q, k, v, window=w)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = launches[f"entry_{name}"] = FA.flash_attention.launches - before
        print(f"[kernel] flash_attention one batch entry S={S} H={H} Kv={Kv} "
              f"hd={hd} causal window {w} {name} "
              f"({FA.route(dtype, hd, S, H // Kv)}): {q.numel():,} elements "
              f"of q, {n} launch, {secs:.3f} s")
        check(q.numel() >= 2 ** 31 and n == 1,
              f"the 2^31-element entry made {n} launches")
        lo = S - rows - w            # keys of the last rows start here
        rtol, atol = (FLASH_RTOL, FLASH_ATOL) if name == "float32" \
            else (TOL[name], QWEN_FLASH_BF16_ATOL)
        held(torch, f"2^31-element entry {name}, last {rows} rows (offsets "
             f"past 2^31) vs plain on positions {lo}..{S - 1}",
             out[:, S - rows:],
             ref.flash_attention(q[:, lo:], k[:, lo:], v[:, lo:],
                                 window=w)[:, w:], rtol, atol)
        held(torch, f"2^31-element entry {name}, first {rows} rows vs plain",
             out[:, :rows], ref.flash_attention(q[:, :rows], k[:, :rows],
                                                v[:, :rows], window=w),
             rtol, atol)
        del q, k, v, out
        torch.cuda.empty_cache()

    B, S, H, Kv, hd = FLASH_GRID_SPLIT
    q, k, v = (randn(torch, (B, S, n, hd), torch.bfloat16, 95 + j, 0.5)
               for j, n in enumerate((H, Kv, Kv)))
    chunks = FA._batch_chunks(B)
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    n = launches["grid"] = FA.flash_attention.launches - before
    check(n == len(chunks) == 2, f"B={B}: {n} launches over {chunks}")
    for b in sorted({0, chunks[0][1] - 1, chunks[1][0], B - 1}):
        alone = FA.flash_attention(*(t[b:b + 1].contiguous()
                                     for t in (q, k, v)))
        check(torch.equal(out[b:b + 1], alone),
              f"batch entry {b} of B={B} differs from the kernel alone")
    held(torch, f"flash_attention B={B} S={S} H={H} Kv={Kv} hd={hd} "
         f"({n} launches over {chunks}) vs plain", out,
         ref.flash_attention(q, k, v), TOL["bfloat16"], TOL["bfloat16"])
    return launches


def plain_kernels(rmsnorm=None):
    """Route the model's kernel calls to the plain versions, on any device,
    for the ``with`` block (the comparison runs of the LSTM, serve and
    training phases: ``ops.FlashAttention``, ``ops.RMSNorm`` and
    ``models/lstm.py::_Seq`` call the patched names too, forward and
    backward); ``rmsnorm`` replaces the plain RMSNorm (the noise-floor
    run). ``ops.lstm_seq`` keeps its kernel: the LSTM comparisons hold the
    backward alone. A moe model's comparison also replays the kernel run's
    expert choices (``recorded_routes`` / ``replayed_routes``)."""
    import contextlib
    from unittest import mock
    from repro_torch.kernels import ops, ref
    stack = contextlib.ExitStack()
    for name, fn in (("rmsnorm", rmsnorm or ref.rmsnorm),
                     ("flash_attention", ref.flash_attention),
                     ("flash_attention_bwd", ref.flash_attention_bwd),
                     ("rmsnorm_bwd", ref.rmsnorm_bwd),
                     ("lstm_seq_bwd", ref.lstm_seq_bwd)):
        stack.enter_context(mock.patch.object(ops, name, fn))
    return stack


class RouteBook:
    """One run's expert choices (``models/moe.py::route``'s idx, in call
    order), to be replayed in another run of the same model: with random
    weights the router's top-k holds near-ties, and a kernel's rounding
    against a plain version's flips an expert choice now and then, which
    changes that token by far more than any kernel error. ``flips`` counts
    the (token, expert) choices a replaying run would have made otherwise;
    ``calls`` the replayed calls; ``alone`` (``hold_logits``) the logits'
    distance from the plain path with one kernel kept."""

    def __init__(self):
        self.idx = []
        self.pos = 0
        self.flips = 0
        self.calls = 0
        self.alone = {}


def recorded_routes(book):
    """``with`` block: every ``moe.route`` call appends its idx to book."""
    from unittest import mock
    from repro_torch.models import moe
    real = moe.route

    def record(probs, k):
        gate, idx = real(probs, k)
        book.idx.append(idx.detach())
        return gate, idx

    return mock.patch.object(moe, "route", record)


def replayed_routes(book):
    """``with`` block: each ``moe.route`` call takes the recorded run's idx
    of the same call (from the start), with the gates read from this run's
    own probabilities at those experts (so the router's gradient stays),
    and counts where this run would have chosen otherwise."""
    from unittest import mock
    from repro_torch.models import moe
    real = moe.route
    book.pos = book.flips = book.calls = 0

    def replay(probs, k):
        idx = book.idx[book.pos].to(probs.device)
        book.pos += 1
        _, own = real(probs, k)
        book.flips += int((chosen(probs, own) & ~chosen(probs, idx)).sum())
        book.calls += 1
        return probs.gather(-1, idx), idx

    return mock.patch.object(moe, "route", replay)


def chosen(probs, idx):
    """[T, E] bool: the experts idx [T, k] chooses."""
    return probs.new_zeros(probs.shape).scatter_(1, idx, 1.0) > 0


def route_drops(torch, book, cfg, capacity_factor):
    """For each recorded call: (tokens, slots an expert C, the (token,
    expert) assignments past their expert's C, the largest expert load)."""
    from repro_torch.models import moe
    out = []
    for idx in book.idx:
        T = idx.shape[0]
        C = moe.capacity(cfg, T, capacity_factor)
        loads = torch.zeros(cfg.moe.num_experts, dtype=torch.int64,
                            device=idx.device).scatter_add_(
            0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
        out.append((T, C, int((loads - C).clamp_min(0).sum()),
                    int(loads.max())))
    return out


def served_drops(torch, book, cfg, tag):
    """The (token, expert) assignments a kernel run recorded in ``book``
    (a teacher-forced prefill, then its decode steps) dropped past their
    expert's capacity at the config's capacity factor, summed over the moe
    layers of each pass; printed under ``tag``."""
    # one router call a moe layer a pass
    L = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    per_call = route_drops(torch, book, cfg, cfg.moe.capacity_factor)
    steps = [per_call[i:i + L] for i in range(0, len(per_call), L)]
    drops = dict(prefill=sum(d for _, _, d, _ in steps[0]),
                 prefill_C=steps[0][0][1],
                 prefill_assignments=steps[0][0][0] * cfg.moe.top_k * L,
                 decode=[sum(d for _, _, d, _ in st) for st in steps[1:]],
                 decode_C=steps[1][0][1],
                 decode_assignments=steps[1][0][0] * cfg.moe.top_k * L)
    print(f"{tag} dropped (token, expert) assignments at capacity factor "
          f"{cfg.moe.capacity_factor}: prefill {drops['prefill']} of "
          f"{drops['prefill_assignments']} (C = {drops['prefill_C']} for "
          f"{steps[0][0][0]} tokens a layer, summed over {L} moe layers); "
          f"decode steps {drops['decode']} of {drops['decode_assignments']} "
          f"each (C = {drops['decode_C']} for {steps[1][0][0]} tokens)")
    return drops


def teacher_forced(torch, M, params, cfg, prompt_toks, gen_toks,
                   extra=None):
    """Prefill (with the batch's ``extra`` entries, an encdec model's
    frames or a vlm model's patches), then decode fed ``gen_toks`` [B, T]
    (the served tokens) from the position after the prompt (and a vlm
    model's patches): the logits of the prefill and of each decode step,
    [T, B, V]."""
    from repro_torch.launch.serve import prefix_len
    from repro_torch.models.runtime import DEFAULT
    B, P = prompt_toks.shape
    T = gen_toks.shape[1]
    start = prefix_len(cfg) + P
    cache = M.init_cache(cfg, B, start + T + 8, device="cuda")
    logits, cache = M.prefill(params, cfg, DEFAULT,
                              {"tokens": prompt_toks, **(extra or {})},
                              cache)
    out = [logits]
    for t in range(T - 1):
        logits, cache = M.decode_step(params, cfg, DEFAULT, gen_toks[:, t],
                                      cache, start + t)
        out.append(logits)
    return torch.stack(out)


def lib_rmsnorm(x, scale, eps=1e-6):
    import torch.nn.functional as F
    return F.rms_norm(x, (x.shape[-1],), scale, eps)


def hold_logits(torch, M, params, cfg, prompt_toks, gen_toks, tag,
                book=None, gate_path=True, extra=None, alone=False):
    """The kernel path, the plain path and the plain path with
    ``F.rms_norm`` (the noise floor), teacher-forced on ``gen_toks``;
    fails unless kernel vs plain is within SERVE_LOGIT_TOL of the logits'
    scale. With ``gate_path`` False (a model whose two plain versions lie
    farther apart than that) the distance is printed, not gated, as long as
    the noise floor really is past the gate. With a ``RouteBook`` (a moe
    model) the kernel run records its expert choices into it and both plain
    runs replay them, and two more replaying runs keep one kernel each (the
    flash kernel with the plain rmsnorm, then the rmsnorm kernel with the
    plain flash), to say which kernel the distance comes from; the flash
    kernel alone is held at SERVE_LOGIT_TOL; ``alone`` asks for those two
    runs and that gate without a book. ``extra`` goes to every prefill (an
    encdec model's frames, a vlm model's patches). Returns (max|kernel-
    plain|, the kernel path's tokens agree, {kernel: max|diff| with that
    kernel alone} or None without ``alone`` or a book)."""
    import contextlib
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import greedy

    def routes(record):
        if book is None:
            return contextlib.nullcontext()
        return recorded_routes(book) if record else replayed_routes(book)

    def run():
        return teacher_forced(torch, M, params, cfg, prompt_toks, gen_toks,
                              extra)

    if book is not None:
        book.__init__()
    alone = alone or book is not None
    with torch.no_grad():
        with routes(True):
            kern = run()
        before = (RN.rmsnorm.launches, FA.flash_attention.launches)
        with plain_kernels(), routes(False):
            plain = run()
        flips = None if book is None else (book.flips, book.calls)
        with plain_kernels(rmsnorm=lib_rmsnorm), routes(False):
            floor = run()
        check((RN.rmsnorm.launches, FA.flash_attention.launches) == before,
              "a plain run launched a kernel")
        if alone:
            # where kernel vs plain comes from: one plain version at a time
            from unittest import mock
            from repro_torch.kernels import ops, ref
            kept_runs = {}
            for kept, name, fn in (
                    ("flash_attention", "rmsnorm", ref.rmsnorm),
                    ("rmsnorm", "flash_attention", ref.flash_attention)):
                with mock.patch.object(ops, name, fn), routes(False):
                    kept_runs[kept] = run()
    if flips is not None:
        print(f"[serve] {tag}: the plain run replayed the kernel run's "
              f"expert choices over {flips[1]} router calls; on its own it "
              f"would have chosen {flips[0]} (token, expert) pairs "
              f"otherwise")
    torch.cuda.synchronize()
    err = (kern - plain).abs().max().item()
    noise = (floor - plain).abs().max().item()
    scale = plain.abs().max().item()
    tol = SERVE_LOGIT_TOL[cfg.dtype]
    limit = tol * scale
    gated = gate_path or noise <= limit
    ok = err <= limit
    verdict = ("ok" if ok else "FAIL") if gated else (
        f"not gated: the plain versions lie {noise / scale:.2%} of "
        f"max|logit| apart, past the gate")
    print(f"[serve] {tag}: prefill + {gen_toks.shape[1] - 1} decode steps, "
          f"logits max|kernel-plain| {err:.3e} ({err / scale:.2%} of "
          f"max|logit|), max|plain-plain with F.rms_norm| {noise:.3e}, "
          f"max|logit| {scale:.3f}; tol {tol} x max|logit| = {limit:.3e} "
          f"{verdict}")
    dist = None
    if alone:
        dist = {k: (v - plain).abs().max().item()
                for k, v in kept_runs.items()}
        if book is not None:
            book.alone = dist
        flash = dist["flash_attention"]
        # without a book, as the whole path: gated where the plain versions
        # lie closer than the gate
        gated_alone = book is not None or gated
        print(f"[serve] {tag}: the kernels one at a time against the plain "
              f"path: the flash kernel alone (plain rmsnorm) max|diff| "
              f"{flash:.3e} ({flash / scale:.2%} of max|logit|; gate "
              f"{limit:.3e} "
              f"{('ok' if flash <= limit else 'FAIL') if gated_alone else 'not gated, as the whole path'}"
              f"), the rmsnorm kernel alone (plain flash) "
              f"{dist['rmsnorm']:.3e}; the whole path's margin "
              f"{100 * (1 - err / limit):.1f}% of {limit:.3e}")
        check(flash <= limit or not gated_alone,
              f"serve logits ({tag}): the flash kernel alone disagrees with "
              f"the plain path")
    check(ok or not gated, f"serve logits ({tag}): kernel path disagrees "
                           f"with the plain path")
    return err, torch.equal(greedy(kern).t(), gen_toks), dist


def phase_serve(torch, K, T):
    """qwen1.5-110b at full width, cut to 4 layers, served through
    ``repro_torch.launch.serve.serve`` with every count set to 0 just
    before and read just after; then the same weights through the plain
    versions on the card, teacher-forced on the served tokens."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch import tree
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import greedy, make_prompts, serve
    from repro_torch.models import model as M

    cfg = C.get(SERVE_ARCH).replace(n_layers=SERVE_LAYERS)
    base_gb = phase_memory(torch, f"serve {cfg.name}")
    reset_counts(K, T)
    t0 = time.perf_counter()
    res = serve(cfg, device="cuda", **SERVE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = serve_counts(K, T)
    routes = dict(FA.flash_attention.route_launches)
    lse_launches = FA.flash_attention.lse_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_batches = -(-SERVE["requests"] // SERVE["batch"])
    per_pass = 2 * SERVE_LAYERS + 1
    want = dict(rmsnorm=per_pass * SERVE["tokens"] * n_batches,
                flash_attention=SERVE_LAYERS * n_batches, rmsnorm_bwd=0,
                others=0)
    toks = res["tokens"]
    # per batch: the first includes the first allocations, the last is warm
    prefill_ms = [t * 1e3 for t in res["prefill_s"]]
    decode_ms = [t / (SERVE["tokens"] - 1) * 1e3 for t in res["decode_s"]]
    tok_s = SERVE["requests"] * SERVE["tokens"] / (sum(res["prefill_s"]) +
                                                  sum(res["decode_s"]))
    print(f"[serve] {cfg.name} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"(of 80) bf16, requests={SERVE['requests']} batch="
          f"{SERVE['batch']} prompt={SERVE['prompt']} tokens="
          f"{SERVE['tokens']}: prefill ms per batch "
          f"{', '.join(f'{t:.2f}' for t in prefill_ms)}; decode ms per "
          f"token step {', '.join(f'{t:.3f}' for t in decode_ms)}; "
          f"{tok_s:.1f} tok/s over the run (wall {wall_s:.1f} s with the "
          f"weights' init); peak memory {peak_gb:.2f} GB; launches {counts} "
          f"(expected {want}), flash_attention by route {routes}")
    check(counts == want and res["launches"] == {
        k: v for k, v in want.items() if k != "others"},
        f"serve launches {counts} / {res['launches']}, expected {want}")
    check(routes == {"wgmma": want["flash_attention"], "wgmma_chunked": 0,
                     "tf32x3": 0, "cuda_core": 0, "hd_chunked": 0},
          f"serve flash_attention routes {routes}: every bf16 launch should "
          f"run the tensor-core kernel")
    print(f"[serve] flash_attention launches that wrote lse: {lse_launches} "
          f"(serving passes the kernels a null lse); backward launches: "
          f"flash_attention_bwd {FA.flash_attention_bwd.launches}, "
          f"lstm_seq_bwd {K.lstm_seq_bwd.launches}")
    check(lse_launches == 0, f"{lse_launches} serve launches wrote lse")
    check(tuple(toks.shape) == (SERVE["requests"], SERVE["tokens"]) and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"served tokens {tuple(toks.shape)} out of shape or range")

    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SERVE["seed"]), "cuda")
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"[serve] parameters: {n_params:,} ({2 * n_params / 1e9:.1f} GB "
          f"bf16)")
    check(n_params == SERVE_PARAMS, f"{n_params} parameters, expected "
                                    f"{SERVE_PARAMS}")
    prompts = make_prompts(cfg, SERVE["requests"], SERVE["prompt"],
                           SERVE["seed"])
    worst = 0.0
    for b0 in range(0, SERVE["requests"], SERVE["batch"]):
        p = torch.from_numpy(np.stack(prompts[b0:b0 + SERVE["batch"]])).cuda()
        g = toks[b0:b0 + SERVE["batch"]].cuda()
        err, same, _ = hold_logits(torch, M, params, cfg, p, g,
                                f"requests {b0}-{b0 + SERVE['batch'] - 1}")
        check(same, "the kernel path gave other tokens on a second run")
        worst = max(worst, err)
    return dict(counts=counts, routes=routes, prefill_ms=prefill_ms,
                decode_ms=decode_ms, tok_s=tok_s, peak_gb=peak_gb,
                base_gb=base_gb, logit_err=worst,
                params=params, cfg=cfg, prompts=prompts)


def phase_serve_fp32(torch, cfg, prompt=SERVE_FP32["prompt"]):
    """A full-width model in fp32 (qwen's 4 layers, 31.7 GB; falcon-mamba-
    7b whole, 29.1 GB; jamba's one period, 51.0 GB; whisper-base and
    internvl2-1b whole, 0.28 and 2.52 GB), where rounding noise is ~1e-5: a
    greedy run through the kernels, its flash launches counted by route
    (one an attention layer in the prefill, the encoder's too, all on
    tf32x3), then kernel vs plain teacher-forced on its tokens within 1e-4
    of the logits' scale (the plain runs replaying the kernel run's expert
    choices where there are experts). An encdec model's frames or a vlm
    model's patches are drawn from the seed with numpy
    (``seeded_extra``). Holds the kernels at full width where bf16 noise
    cannot hide an error. Returns (max|kernel - plain|, the greedy run's
    flash launches by route)."""
    import numpy as np
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import greedy, make_prompts, prefix_len
    from repro_torch.models import model as M
    from repro_torch.models.runtime import DEFAULT

    check(cfg.dtype == "float32", f"{cfg.name} is {cfg.dtype}")
    phase_memory(torch, f"serve {cfg.name} fp32")
    B, P, Tn = SERVE_FP32["batch"], prompt, SERVE_FP32["tokens"]
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SERVE["seed"]), "cuda")
    p = torch.from_numpy(np.stack(make_prompts(cfg, B, P, SERVE["seed"]))) \
        .cuda()
    extra = seeded_extra(torch, cfg, B, SERVE["seed"])
    start = prefix_len(cfg) + P
    before = dict(FA.flash_attention.route_launches)
    with torch.no_grad():
        cache = M.init_cache(cfg, B, start + Tn + 8, device="cuda")
        logits, cache = M.prefill(params, cfg, DEFAULT,
                                  {"tokens": p, **extra}, cache)
        toks = [greedy(logits)]
        for t in range(Tn - 1):
            logits, cache = M.decode_step(params, cfg, DEFAULT, toks[-1],
                                          cache, start + t)
            toks.append(greedy(logits))
    torch.cuda.synchronize()
    routes = {r: n - before[r]
              for r, n in FA.flash_attention.route_launches.items()}
    want = dict.fromkeys(routes, 0) | {"tf32x3": attention_layers(cfg)}
    print(f"[serve] {cfg.name} fp32 greedy run, flash_attention launches by "
          f"route {routes} (expected {want}: one an attention layer in the "
          f"prefill)")
    check(routes == want, f"fp32 serve flash routes {routes}, expected "
                          f"{want}")
    book = RouteBook() if cfg.moe.num_experts else None
    err, _, _ = hold_logits(torch, M, params, cfg, p, torch.stack(toks, 1),
                            f"{cfg.name} fp32 ({cfg.n_layers} layers), batch "
                            f"{B}, prompt {P}", book=book, extra=extra)
    return err, routes


def attention_layers(cfg) -> int:
    """The self-attention layers a prefill runs, each one flash launch: an
    encdec model's encoder layers too."""
    n = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    return n + (cfg.n_encoder_layers if cfg.family == "encdec" else 0)


def prefill_fwd_kernels(cfg, passes: int = 1) -> dict:
    """{forward kernel: launches} that ``passes`` bf16 prefills (or
    forwards) of cfg run: one flash launch an attention layer, all on the
    route's kernel at the width the wrapper runs the config's hd at (64,
    128 or 192) and G, ``fwd_pipe_kernel``; none for a model without
    attention."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    n = attention_layers(cfg) * passes
    wide = FA.native_head_dim(cfg.hd, torch.bfloat16)
    return {fwd_pipe_kernel(wide, cfg.n_heads // cfg.n_kv_heads): n} \
        if n else {}


def seeded_extra(torch, cfg, batch: int, seed: int) -> dict:
    """An encdec model's frames or a vlm model's patches for ``batch``
    rows (``serve.extra_inputs``' shapes), ``randn`` from
    ``np.random.RandomState(seed)`` in the config's dtype on the card;
    nothing for the other families."""
    import numpy as np
    from repro_torch.launch.serve import extra_inputs
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*z.shape).astype(np.float32))
            .to("cuda", z.dtype)
            for k, z in extra_inputs(cfg, batch, "meta").items()}


def serve_profile(torch, cfg, params, prompts, extra=None):
    """Where a prefill of ``prompts`` (a batch of numpy prompts; with
    ``extra``, an encdec model's frames or a vlm model's patches) and one
    decode step spend the card (torch.profiler), and each kernel's device
    time per launch on the serve path; the prefill's flash forward kernels
    held to ``prefill_fwd_kernels``, the decode step's to none. After the
    counts were read."""
    import numpy as np
    from repro_torch.launch.serve import greedy, prefix_len
    from repro_torch.models import model as M
    from repro_torch.models.runtime import DEFAULT

    toks = torch.from_numpy(np.stack(prompts)).cuda()
    B, P = toks.shape
    start = prefix_len(cfg) + P
    state = {}

    def pre():
        cache = M.init_cache(cfg, B, start + SERVE["tokens"] + 8,
                             device="cuda")
        logits, state["cache"] = M.prefill(
            params, cfg, DEFAULT, {"tokens": toks, **(extra or {})}, cache)
        state["tok"] = greedy(logits)

    def dec():
        M.decode_step(params, cfg, DEFAULT, state["tok"], state["cache"],
                      start)

    out = {}
    with torch.no_grad():
        pre()
        dec()
        for key, fn in (("prefill", pre), ("decode", dec)):
            window_ms, busy_ms, n_kernels, by_name, host = profiled(torch,
                                                                    fn)
            print(f"[profile] {cfg.name} one {key} (B={B}, {P} prompt "
                  f"tokens): window {window_ms:.2f} ms, device busy "
                  f"{busy_ms:.2f} ms ({100 * busy_ms / window_ms:.1f}%), "
                  f"{n_kernels} kernels")
            for name, (n, t) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1])[:6]:
                print(f"[profile]   {t:.3f} ms in {n} x {name[:90]}")
            for name, n, t in host[:8]:
                print(f"[profile]   host: {t:.3f} ms self in {n} x "
                      f"{name[:80]}")
            out[key] = dict(
                window_ms=window_ms, busy_ms=busy_ms, kernels=n_kernels,
                # rmsnorm_{row,warp,}kernel; flash_kernel_wgmma_pipe (bf16)
                rmsnorm_ms=per_launch_ms(by_name, "rmsnorm_"),
                flash_ms=per_launch_ms(by_name, "flash_kernel"),
                fwd_kernels=check_fwd_kernels(
                    f"{cfg.name} one {key}", by_name,
                    prefill_fwd_kernels(cfg) if key == "prefill" else {}))
            print(f"[profile] device time per launch in the {key}: rmsnorm "
                  f"{fmt_ms(out[key]['rmsnorm_ms'])}, flash_attention "
                  f"{fmt_ms(out[key]['flash_ms'])}")
    return out


def layer_norms(cfg) -> int:
    """The RMSNorms of cfg's layers: norm1 a layer, and norm2 outside the
    ssm family (whose layers stop after the mixer)."""
    return cfg.n_layers * (1 if cfg.family == "ssm" else 2)


def smoke_launches(cfg, passes: int):
    """(rmsnorm, flash) launches of a prefill and ``passes - 1`` decode
    steps: with RMSNorm, norm1 (and norm2 outside the ssm family) a layer
    and the final norm each pass (none with LayerNorm); one flash launch
    per self-attention layer in the prefill (``attention_layers``)."""
    norms = layer_norms(cfg) + 1
    if cfg.norm != "rmsnorm":
        norms = 0
    return norms * passes, attention_layers(cfg)


def phase_smoke_cpu(torch):
    """The smoke configs of every family the port serves in fp32 (qwen1.5-
    110b; the moe family's deepseek-moe-16b and arctic-480b; falcon-mamba-7b;
    jamba-v0.1-52b; whisper-base; internvl2-1b): the kernel path on the
    card against the plain path on the CPU, from the same weights, prompt
    (and frames or patches, from a numpy seed), prefill + 3 greedy decode
    steps, and outside the dense family also ``forward``'s logits (and the
    router loss where there are experts); the CPU runs replay the card's
    expert choices."""
    import contextlib
    import numpy as np
    import repro_torch.configs as C
    from repro_torch import tree
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import greedy, prefix_len
    from repro_torch.models import model as M
    from repro_torch.models.runtime import DEFAULT

    phase_memory(torch, "smoke configs card vs CPU")
    for arch in (SERVE_ARCH, *MOE_SMOKE_ARCHS, SSM_ARCH, HYBRID_ARCH,
                 ENCDEC_ARCH, VLM_ARCH):
        cfg = C.get_smoke(arch)
        routed = cfg.moe.num_experts > 0
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab, size=(2, 9)).astype(np.int32))
        extra = {k: t.cpu() for k, t in seeded_extra(torch, cfg, 2,
                                                     1).items()}
        start = prefix_len(cfg) + 9
        book = RouteBook()
        runs, fwd = {}, {}
        before = (RN.rmsnorm.launches, FA.flash_attention.launches)
        for dev in ("cuda", "cpu"):
            routes = contextlib.nullcontext()
            if routed:
                routes = recorded_routes(book) if dev == "cuda" else \
                    replayed_routes(book)
            p = tree.to_device(params, dev)
            batch = {k: t.to(dev) for k, t in
                     dict(extra, tokens=toks).items()}
            with routes:
                cache = M.init_cache(cfg, 2, start + 11, device=dev)
                logits, cache = M.prefill(p, cfg, DEFAULT, batch, cache)
                outs = [logits]
                for t in range(3):
                    logits, cache = M.decode_step(p, cfg, DEFAULT,
                                                  greedy(outs[-1]), cache,
                                                  start + t)
                    outs.append(logits)
                runs[dev] = torch.stack(outs).cpu()
                if dev == "cuda":
                    launched = (RN.rmsnorm.launches - before[0],
                                FA.flash_attention.launches - before[1])
                if cfg.family != "dense":
                    with torch.no_grad():
                        lg, aux = M.forward(p, cfg, DEFAULT, batch)
                    fwd[dev] = (lg.cpu(), float(aux))
        err = (runs["cuda"] - runs["cpu"]).abs().max().item()
        same = torch.equal(greedy(runs["cuda"]), greedy(runs["cpu"]))
        ok = same and err <= SMOKE_LOGIT_TOL
        extra = ""
        if cfg.family != "dense":
            f_err = (fwd["cuda"][0] - fwd["cpu"][0]).abs().max().item()
            ok = ok and f_err <= SMOKE_LOGIT_TOL
            extra = f"; forward logits max|diff| {f_err:.3e}"
        if routed:
            a_rel = abs(fwd["cuda"][1] - fwd["cpu"][1]) / fwd["cpu"][1]
            ok = ok and a_rel <= SMOKE_LOGIT_TOL
            extra += (f", router loss rel {a_rel:.3e} (the CPU replayed the "
                      f"card's expert choices; on its own it would have "
                      f"chosen {book.flips} of the last run's pairs "
                      f"otherwise)")
        want = smoke_launches(cfg, 4)
        print(f"[smoke] {cfg.name} smoke fp32, card kernels vs CPU plain: "
              f"greedy tokens equal {same}, logits max|diff| {err:.3e} "
              f"tol={SMOKE_LOGIT_TOL}{extra}; card launches rmsnorm/flash "
              f"{launched} (expected {want})")
        check(ok, f"{arch}: card and CPU disagree at smoke size")
        check(launched == want, f"{arch}: smoke launches {launched}, "
                                f"expected {want}")


# ---------------------------------------------------------------------------
# transformer training (launch/train.py --arch): the kernels under autograd,
# then stablelm-1.6b at its full published size
# ---------------------------------------------------------------------------

TRAIN_ARCH = "stablelm-1.6b"
# the full-width leg: 8 microbatches of 1 x 4,096 tokens a step, AdamW,
# remat on; one warm-up step, then TRAIN_STEPS - 1 timed
TRAIN = dict(batch=8, seq=4096, micro=8, lr=1e-3, optimizer="adamw", seed=0)
TRAIN_STEPS = 4
TRAIN_PARAMS = 1_644_367_872
TRAIN_LAYERS = 24
# flash launches a step: one a layer a microbatch, and once more under remat
# (the layer's forward recomputed in the backward); every one writes lse
TRAIN_FLASH = {True: TRAIN_LAYERS * 8 * 2, False: TRAIN_LAYERS * 8}
# flash backward calls a step, remat or not: one a layer a microbatch (remat
# recomputes the forward, never the backward), each two kernel launches
TRAIN_FLASH_BWD_CALLS = TRAIN_LAYERS * 8
# kernel step against the plain step on the card, bf16: the two forwards
# round bf16 activations at other places (the flash output through the
# tensor cores' hi + lo P V against the plain softmax), and 24 layers of
# bf16 carry that into every gradient; as the served logits, each gradient
# leaf is held to 2e-2 of its max |g| (tests/test_kernels.py::_tol, bf16),
# the loss to 2e-2 relative, with the bf16 plain step's own distance from
# an fp32 plain step printed beside
TRAIN_GRAD_TOL = 2e-2
TRAIN_LOSS_RTOL = 2e-2
# the flash backward kernels against the plain backward on the card, both
# from the kernel forward's out and lse, of max |grad|: fp32 (tf32x3: each
# product as three TF32 products, summed in short chains and in another
# order, which tests/test_torch_bwd_kernels.py models against JAX) at
# tests/test_kernels.py::_tol's 2e-5; bf16 (tensor cores: P and dS rounded
# once to bf16 before their products, which tests/test_torch_bwd_kernels.py
# models on the CPU against JAX's _fa_bwd) at TRAIN_GRAD_TOL
FLASH_BWD_TOL = {"float32": 2e-5, "bfloat16": TRAIN_GRAD_TOL}
# widths beside 64 and 128 the backward is held at, in both dtypes: hd 80
# (bf16 zero-padded to 128 on the tensor cores), nemotron-4-340b's 192 and
# 256 (bf16 on the tensor cores, dk/dv split over two warpgroups), 300
# (bf16 zero-padded to 320), 576 and 1,024 (bf16 above 256: the tensor
# cores in column blocks, hd in 64-column chunks, 2 / 3 / 4 column blocks
# of 192 / 192 / 256); fp32 on tf32x3 at every width (80 and 300 zero-padded
# to 96 and 320)
FLASH_BWD_WIDE = (80, 192, 256, 300, 576, 1024)
# widths the CUDA-core pair is still held at in both dtypes, its C
# functions called directly, as the yardstick of the tensor-core routes
# that replaced it: 192 and 576
FLASH_BWD_CC = (192, 576)
# one batch entry of exactly 2^31 elements of q at hd 256 (the split dk/dv
# kernel) and at hd 1,024 (the column kernels), window FLASH_ENTRY_WINDOW,
# bf16
FLASH_BWD_ENTRY_WIDE = (1, 65536, 128, 16, 256)
FLASH_BWD_ENTRY_COLS = (1, 32768, 64, 8, 1024)
# the smoke configs' step, card against CPU, fp32: the same math summed in
# other orders (cuBLAS, the kernels' trees)
TRAIN_SMOKE_TOL = 1e-4
TRAIN_SMOKE = dict(batch=4, seq=16, micro=2)
# kernel-level shapes of the training path (B, S, H, Kv, hd, causal), bf16:
# stablelm-1.6b's attention (B=1 microbatch, S=4,096, MHA, hd 64),
# qwen1.5-110b's (GQA 64/8, hd 128), nemotron-4-340b's (B=1, S=4,096, GQA
# 96/8, hd 192), whisper-base's encoder (a microbatch of 2 rows of 1,500
# frames, non-causal: 23 full kv tiles of 64 and a ragged 28) and
# internvl2-1b's (1 x 4,096, 14 over 2 heads: G = 7, so a 64-row tile of
# folded rows starts inside a position) and jamba-v0.1-52b's attention
# layer (1 x 4,096, 32 over 8 heads, hd 128: G = 4, which no other
# training shape has); RMSNorm at qwen's [4096, 8192]
TRAIN_FLASH_SHAPES = {"stablelm-1.6b": (1, 4096, 32, 32, 64, True),
                      "qwen1.5-110b": (1, 1024, 64, 8, 128, True),
                      "nemotron-4-340b": (1, 4096, 96, 8, 192, True),
                      "whisper-base": (2, 1500, 8, 8, 64, False),
                      "internvl2-1b": (1, 4096, 14, 2, 64, True),
                      "jamba-v0.1-52b": (1, 4096, 32, 8, 128, True)}
TRAIN_RMS_SHAPE = (4096, 8192)
# the kernel's lse against the plain lse (fp32 scores of bf16 inputs, summed
# in another order; the tensor-core kernel's ex2.approx and log2 in the log2
# domain): |lse - plain| <= rtol * |plain| + atol
TRAIN_LSE_TOL = (1e-5, 1e-5)
# the other routes' lse (B, S, H, Kv, hd, dtype, route), GQA G = 2,
# causal: flash_kernel_tf32x3 at hd 256 and 576 (fp32; at 576 column block
# 0's warpgroup 0 writes it), flash_kernel_wgmma<256> (bf16),
# flash_kernel_wgmma_cols at hd 576 and 1,024 (bf16; column block 0 writes
# it)
TRAIN_LSE_ROUTES = ((1, 256, 4, 2, 256, "float32", "tf32x3"),
                    (1, 256, 4, 2, 256, "bfloat16", "wgmma"),
                    (1, 256, 4, 2, 576, "bfloat16", "wgmma_chunked"),
                    (1, 256, 4, 2, 1024, "bfloat16", "wgmma_chunked"),
                    (1, 256, 4, 2, 576, "float32", "tf32x3"))


def flash_bwd_bound_ms(B, S, H, Kv, hd, elem_bytes=2, peak=None,
                       causal=True):
    """The causal backward's work: five products over the S(S+1)/2 visible
    pairs of each head (S^2 without the causal mask; s = q k^T recomputed,
    dv, dp, dq, dk; 2 flops a
    multiply-add) at the peak rate of its inputs' type (bf16: the tensor
    cores; fp32: the TF32 tensor cores at a third of their rate, each fp32
    product being three TF32 products, PEAK_TF32X3_FLOP_S, the least time
    the card takes for fp32-accurate products; ``peak`` overrides, e.g.
    PEAK_FP32_FLOP_S for the CUDA cores); q, k, v, out and dout read once,
    lse once (fp32), dq, dk and dv written once, in the inputs' type."""
    flops = 5 * 2 * B * H * hd * (S * (S + 1) // 2 if causal else S * S)
    moved = elem_bytes * (3 * B * S * H * hd + 4 * B * S * Kv * hd) + \
        4 * B * H * S
    if peak is None:
        peak = PEAK_BF16_FLOP_S if elem_bytes == 2 else PEAK_TF32X3_FLOP_S
    t_b, t_o = moved / PEAK_BYTES_S, flops / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def x3_cols(hd):
    """The output columns a warpgroup of the tf32x3 backward owns at hd, as
    ``x3::warp_cols`` in flash_attention_bwd.cu sets them: (dq's, dk/dv's);
    a dq block owns twice its warpgroup's columns, a dk/dv block as many."""
    return (64 if hd <= 128 else 128 if hd <= 256 else 256,
            64 if hd <= 64 else 128 if hd <= 128 else 256)


def x3_work(B, S, H, Kv, hd):
    """A model of what the tf32x3 backward does in one causal call, counted
    from the shapes and the kernels' tiling, not measured: (full-width
    products over the visited 64 x 64 tile pairs, GB requested by TMA).
    Each column block (``x3_cols``) forms S and dP again (dq: 2 products
    and dS k; dk/dv: 2 and P^T dout, dS^T q), and requests for each tile
    pair the own side's 64 rows and the other side's 64 positions of its
    four inputs over the full width, then the other side's rows of its
    output columns (dq: k's; dk/dv: q's and dout's)."""
    wc_q, wc_kv = x3_cols(hd)
    cb_q, cb_kv = -(-hd // (2 * wc_q)), -(-hd // wc_kv)
    n_t = -(-S // 64)
    pairs = B * H * n_t * (n_t + 1) // 2       # visited tile pairs a launch
    exact = B * H * S * (S + 1) // 2 / (pairs * 64 * 64)
    products = (2 * (cb_q + cb_kv) + 3) / exact
    moved = pairs * 4 * (64 * hd * (4 * cb_q + 4 * cb_kv) +
                         64 * hd * (1 + 2))
    return products, moved / 1e9


def grads_of(torch, fn, leaves, cot):
    """Gradients of ``fn(*leaves)`` (leaves made to require grad) for the
    cotangent ``cot``."""
    xs = [t.detach().clone().requires_grad_() for t in leaves]
    return torch.autograd.grad(fn(*xs), xs, cot)


def rel_err(torch, got, want) -> float:
    """max|got - want| over max|want|."""
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp_min(1e-30)).item()


def flash_bwd_sweep(torch, FA, ref):
    """The flash backward kernels against the plain backward, both from the
    kernel forward's out and lse: the JAX sweep x {causal, window 37, full}
    in fp32 (``tf32x3``; hd 16 zero-padded to 32) and bf16 (tensor cores;
    hd 16 and 32 zero-padded to 64), again at hd 128 in bf16 (GQA and MQA
    included), and its GQA shape at ``FLASH_BWD_WIDE`` in both dtypes (bf16
    on ``wgmma`` up to 256, 80 padded to 128, and on ``wgmma_chunked``
    above; fp32 on ``tf32x3`` at every width, 80 and 300 padded); each
    call counted on its route, and as padded where it ran at a wider
    width, and a second call bit for bit equal. Returns the worst relative
    error by dtype."""
    from repro_torch.kernels import ops
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(shape, dt) for shape in FLASH_SWEEP
             for dt in ("float32", "bfloat16")] + \
        [((B, S, H, Kv, FLASH_HD_WIDE), "bfloat16")
         for B, S, H, Kv, _ in FLASH_SWEEP] + \
        [((*FLASH_SWEEP[1][:4], hd), dt) for hd in FLASH_BWD_WIDE
         for dt in ("float32", "bfloat16")]
    for (B, S, H, Kv, hd), dt in cases:
        dtype = getattr(torch, dt)
        path = FA.bwd_route(dtype, hd)
        width = FA.bwd_head_dim(hd, dtype)
        for causal, window in FLASH_MASKS:
            q, k, v, do = (randn(torch, (B, S, n, hd), dtype, 300 + j)
                           for j, n in enumerate((H, Kv, Kv, H)))
            o, lse = FA.flash_attention(q, k, v, causal=causal,
                                        window=window, with_lse=True)
            before = (FA.flash_attention_bwd.route_launches[path],
                      FA.flash_attention_bwd.padded_launches)
            got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         window=window)
            want = ref.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           chunk=min(ops.KV_CHUNK, S))
            torch.cuda.synchronize()
            n = FA.flash_attention_bwd.route_launches[path] - before[0]
            n_pad = FA.flash_attention_bwd.padded_launches - before[1]
            errs = [rel_err(torch, a, b) for a, b in zip(got, want)]
            # a second run bit for bit equal (the bf16 kernels at hd 64 and
            # 128 sum over warpgroups and cluster blocks in a fixed order)
            same = all(torch.equal(a, b) for a, b in zip(
                got, FA.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal, window=window)))
            ok = max(errs) <= FLASH_BWD_TOL[dt] and same and all(
                a.dtype == dtype and a.shape == t.shape
                for a, t in zip(got, (q, k, v)))
            print(f"[train] flash_attention_bwd B={B} S={S} H={H} Kv={Kv} "
                  f"hd={hd} {dt} causal={causal} window={window} ({path} at "
                  f"hd {width}, {n} launches): max|kernel-plain| / max|grad| "
                  f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} tol "
                  f"{FLASH_BWD_TOL[dt]}; two runs bit-equal {same} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention_bwd disagrees with its plain version "
                      f"or between two runs at B={B} S={S} H={H} Kv={Kv} "
                      f"hd={hd} {dt} causal={causal} window={window}")
            check(n == FA.BWD_LAUNCHES and
                  n_pad == (n if width != hd else 0),
                  f"flash_attention_bwd counted {n} launches on {path}, "
                  f"{n_pad} padded (hd {hd} runs at {width})")
            worst[dt] = max(worst[dt], max(errs))
    return worst


def cuda_core_bwd(torch, FA, q, k, v, o, lse, do, causal=True, window=0):
    """The CUDA-core backward pair of q's dtype (``flash_bwd_dq_cc``, then
    ``flash_bwd_dkdv_cc``; C functions ``flash_bwd_dq_bf16_cc`` /
    ``flash_bwd_dq_f32`` and their dk/dv launches), called through its C
    functions at q's width, for comparison and timing beside the routes
    that replaced it (bf16: ``wgmma`` and ``wgmma_chunked``; fp32:
    ``tf32x3``). Returns (dq, dk, dv)."""
    B, S, H, hd = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    for fn, ptrs in zip(FA.build_bwd()[q.dtype, "cuda_core"],
                        ((q, k, v, o, do, lse, dsum, dq),
                         (q, k, v, do, lse, dsum, dk, dv))):
        err = fn(*(t.data_ptr() for t in ptrs), B, S, H, k.shape[2], hd,
                 int(causal), window, 1.0 / math.sqrt(hd), stream)
        check(err == 0, f"the {q.dtype} CUDA-core backward pair failed to "
                        f"launch: {err}")
    return dq, dk, dv


def flash_bwd_cc_gate(torch, FA, ref):
    """The CUDA-core pair of each dtype through its C functions at
    ``FLASH_BWD_CC``, the sweep's GQA shape x the masks, against the plain
    backward from the kernel forward's out and lse, at the dtype's
    ``FLASH_BWD_TOL``. Returns the worst relative error by dtype."""
    from repro_torch.kernels import ops
    B, S, H, Kv = FLASH_SWEEP[1][:4]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for (dt, tol), hd in itertools.product(FLASH_BWD_TOL.items(),
                                           FLASH_BWD_CC):
        dtype = getattr(torch, dt)
        for causal, window in FLASH_MASKS:
            q, k, v, do = (randn(torch, (B, S, n, hd), dtype, 320 + j)
                           for j, n in enumerate((H, Kv, Kv, H)))
            o, lse = FA.flash_attention(q, k, v, causal=causal,
                                        window=window, with_lse=True)
            got = cuda_core_bwd(torch, FA, q, k, v, o, lse, do, causal,
                                window)
            want = ref.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           chunk=min(ops.KV_CHUNK, S))
            errs = [rel_err(torch, a, b) for a, b in zip(got, want)]
            ok = max(errs) <= tol
            print(f"[train] the {dt} CUDA-core backward pair (C functions) "
                  f"B={B} S={S} H={H} Kv={Kv} hd={hd} causal={causal} "
                  f"window={window}: max|pair-plain| / max|grad| dq "
                  f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} tol "
                  f"{tol} {'ok' if ok else 'FAIL'}")
            check(ok, f"the {dt} CUDA-core backward pair disagrees with the "
                      f"plain backward at hd {hd} causal={causal} "
                      f"window={window}")
            worst[dt] = max(worst[dt], max(errs))
    return worst


def flash_bwd_entry(torch, FA, ref):
    """The flash backward on one batch entry of exactly 2^31 elements of q,
    window 256, causal: at hd 128 (FLASH_ENTRY) in bf16 (tensor cores) and
    fp32 (``tf32x3``), at hd 256 (FLASH_BWD_ENTRY_WIDE) in bf16 (the split
    dk/dv kernel) and at hd 1,024 (FLASH_BWD_ENTRY_COLS) in bf16 (the column
    kernels), one call each: dq of the first and last 1,024 rows
    and dk, dv of the positions whose every pair lies in the same slices,
    against the plain backward on slices of 1,024 + 256 positions (the
    kernel forward's out and lse sliced). Returns the seconds of each
    call."""
    from repro_torch.kernels import ops
    w, rows = FLASH_ENTRY_WINDOW, 1024
    secs = {}
    for shape, dtype in ((FLASH_ENTRY, torch.bfloat16),
                         (FLASH_ENTRY, torch.float32),
                         (FLASH_BWD_ENTRY_WIDE, torch.bfloat16),
                         (FLASH_BWD_ENTRY_COLS, torch.bfloat16)):
        B, S, H, Kv, hd = shape
        dt = str(dtype).split(".")[-1]
        name = f"hd{hd}/{dt}"
        q, k, v, do = (randn(torch, (B, S, n, hd), dtype, 400 + j, 0.5)
                       for j, n in enumerate((H, Kv, Kv, H)))
        o, lse = FA.flash_attention(q, k, v, window=w, with_lse=True)
        before = FA.flash_attention_bwd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dq, dk, dv = FA.flash_attention_bwd(q, k, v, o, lse, do, window=w)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        n = FA.flash_attention_bwd.launches - before
        # (slice, its dq rows, its dk/dv positions that see all their pairs)
        for lo, hi, q_rows, kv_rows in (
                (0, rows + w, slice(0, rows), slice(0, rows)),
                (S - rows - w, S, slice(w, rows + w), slice(0, rows + w))):
            cut = [t[:, lo:hi].contiguous() for t in (q, k, v, o)]
            want = ref.flash_attention_bwd(
                *cut, lse[:, :, lo:hi].contiguous(),
                do[:, lo:hi].contiguous(), window=w, chunk=ops.KV_CHUNK)
            got = (dq[:, lo:hi], dk[:, lo:hi], dv[:, lo:hi])
            errs = [rel_err(torch, g[:, r], p[:, r]) for g, p, r in zip(
                got, want, (q_rows, kv_rows, kv_rows))]
            ok = max(errs) <= FLASH_BWD_TOL[dt]
            print(f"[train] flash_attention_bwd on one entry of "
                  f"{q.numel():,} elements (B={B} S={S} H={H} Kv={Kv} "
                  f"hd={hd}, window {w}) {dt} "
                  f"({FA.bwd_route(dtype, hd)}): {n} launches, "
                  f"{secs[name]:.3f} s; positions {lo}..{hi - 1} vs the "
                  f"plain backward on that slice: max|diff| / max|grad| dq "
                  f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} tol "
                  f"{FLASH_BWD_TOL[dt]} {'ok' if ok else 'FAIL'}")
            check(q.numel() == 2 ** 31 and n == FA.BWD_LAUNCHES and ok,
                  f"flash_attention_bwd on the 2^31-element entry, {name}, "
                  f"positions {lo}..{hi - 1}: {n} launches, errors {errs}")
        del q, k, v, do, o, lse, dq, dk, dv, cut, want, got
        torch.cuda.empty_cache()
    return secs


def bwd_registers(FA, hd, path="wgmma"):
    """ptxas's registers and spills of the tensor-core backward kernels of
    ``path`` at head width hd: bf16 up to 256 those instantiated at hd,
    above it the column kernels (both of their column blocks); fp32
    (``tf32x3``) the two instantiated at the output columns a warpgroup
    owns at hd (``x3_cols``)."""
    from repro_torch.kernels import build as kbuild
    report = ptxas_report(kbuild.log_path(FA.BWD_SOURCE).read_text())
    if path == "tf32x3":
        dq, kv = x3_cols(hd)
        return {name: rep for name, rep in report
                if f"dq_tf32x3<Li{dq}>" in name or
                f"dkdv_tf32x3<Li{kv}>" in name}
    cols = hd > 256
    return {name: rep for name, rep in report
            if "wgmma" in name and ("_cols" in name) == cols and
            (cols or f"Li{hd}>" in name)}


# widths the flash backward is timed at, qwen's prefill shape: bf16 192
# (nemotron-4-340b's) and 256 on the tensor cores (wgmma), 576 and 1,024 on
# the column kernels (wgmma_chunked); fp32 (tf32x3) at the configs' widths
# (64, 128, 192) and above; each beside the CUDA-core pair it replaced
FLASH_BWD_TIMED = {"bfloat16": (192, 256, 576, 1024),
                   "float32": (64, 128, 192, 256, 576, 1024)}
# the pair at this width or above takes seconds a call: one timed call
FLASH_BWD_ONE_CALL = 1024
# fp32 up to this width is gated faster than SDPA's forward + backward too
FLASH_BWD_FP32_SDPA_GATE = 256
# the tensor-core backward routes (each timed beside the CUDA-core pair)
BWD_TC_ROUTES = ("wgmma", "wgmma_chunked", "tf32x3")


def flash_bwd_wide_times(torch, FA, ref):
    """The flash backward at qwen's prefill shape (B=4, S=1,024, 64 over 8
    heads, causal) at FLASH_BWD_TIMED, from the kernel forward's out and
    lse: its time beside SDPA's forward + backward (timed only; the backend
    it picked named), the five-product bound (fp32: at the three-product
    TF32 rate and at the CUDA cores' 67 TFLOP/s), the plain backward and
    the CUDA-core pair each route replaced (its C functions, in the same
    call; one call at FLASH_BWD_ONE_CALL and above), gated faster than the
    pair; bf16 above hd 256 and fp32 up to FLASH_BWD_FP32_SDPA_GATE also
    faster than SDPA's forward + backward; two runs gated bit for bit
    equal, with each launch's device time (three profiled calls) and
    ptxas's registers and spills of their kernels. Their agreement with the
    plain backward at these widths is gated in ``flash_bwd_sweep``
    (FLASH_BWD_WIDE), at the training shapes and under autograd
    (``flash_bwd_autograd_cols``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    B, S, H, Kv = SERVE["batch"], SERVE["prompt"], 64, 8
    out = {}
    for name, widths in FLASH_BWD_TIMED.items():
        dtype = getattr(torch, name)
        for hd in widths:
            path = FA.bwd_route(dtype, hd)
            check(path in BWD_TC_ROUTES, f"hd {hd} {name} routes to {path}")
            q, k, v, do = (randn(torch, (B, S, n, hd), dtype, 400 + j, 0.5)
                           for j, n in enumerate((H, Kv, Kv, H)))
            o, lse = FA.flash_attention(q, k, v, with_lse=True)
            one = (1, 1, 0) if hd >= FLASH_BWD_ONE_CALL else (2, 1, 1)
            reps, inner, warm = 5, 3, 1
            before = FA.flash_attention_bwd.route_launches[path]
            ms = median_ms(lambda: FA.flash_attention_bwd(q, k, v, o, lse,
                                                          do),
                           torch, reps=reps, inner=inner, warm=warm)
            check(FA.flash_attention_bwd.route_launches[path] - before ==
                  (reps * inner + warm) * FA.BWD_LAUNCHES,
                  f"the hd {hd} {name} backward did not run on {path}")
            qt, kt, vt = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))

            def sdpa_fb():
                y = F.scaled_dot_product_attention(
                    qt.transpose(1, 2), kt.transpose(1, 2),
                    vt.transpose(1, 2), is_causal=True, enable_gqa=True)
                torch.autograd.grad(y, (qt, kt, vt), do.transpose(1, 2))

            torch.use_deterministic_algorithms(False)
            try:
                lib_ms = median_ms(sdpa_fb, torch, reps=5, inner=3, warm=1)
                backend = sdpa_backend(torch, sdpa(torch, q, k, v))
            finally:
                torch.use_deterministic_algorithms(True)
            bound, by = flash_bwd_bound_ms(B, S, H, Kv, hd, q.element_size())
            row = dict(ms=ms, bound_ms=bound, bound_by=by,
                       sdpa_fwd_bwd_ms=lib_ms, sdpa_backend=backend,
                       route=path)
            fp32_bound = ""
            if dtype == torch.float32:
                cc_bound = flash_bwd_bound_ms(B, S, H, Kv, hd, 4,
                                              PEAK_FP32_FLOP_S)[0]
                products, gb = x3_work(B, S, H, Kv, hd)
                fp32_bound = (f"; bound at the CUDA cores' 67 TFLOP/s "
                              f"{cc_bound:.4f} ms ({ms / cc_bound:.2f}x); "
                              f"modelled from the shapes, not measured: "
                              f"{products:.2f} full-width products (each "
                              f"three TF32 products), {gb:.1f} GB requested "
                              f"by TMA")
            first = FA.flash_attention_bwd(q, k, v, o, lse, do)
            same = all(torch.equal(a, b) for a, b in zip(
                first, FA.flash_attention_bwd(q, k, v, o, lse, do)))
            check(same, f"hd {hd} {name}: two runs of the tensor-core "
                        f"backward differ")
            del first
            cc_ms = median_ms(lambda: cuda_core_bwd(
                torch, FA, q, k, v, o, lse, do), torch, *one)
            check(ms < cc_ms, f"hd {hd} {name}: the tensor-core backward "
                              f"({ms:.4f} ms) is not faster than the "
                              f"CUDA-core pair it replaced ({cc_ms:.4f} ms)")
            if path == "wgmma_chunked" or (
                    path == "tf32x3" and hd <= FLASH_BWD_FP32_SDPA_GATE):
                check(ms < lib_ms, f"hd {hd} {name}: the {path} backward "
                                   f"({ms:.4f} ms) is not faster than "
                                   f"SDPA's forward + backward "
                                   f"({backend}, {lib_ms:.4f} ms)")
            plain_ms = median_ms(lambda: ref.flash_attention_bwd(
                q, k, v, o, lse, do, chunk=ops.KV_CHUNK), torch, reps=2,
                inner=1, warm=1)
            regs = bwd_registers(FA, hd, path)
            by_name = profiled(torch, lambda: FA.flash_attention_bwd(
                q, k, v, o, lse, do), reps=3)[3]
            launch_ms = {}
            for kname, (n, t) in by_name.items():
                m = re.search(r"flash_bwd_\w+<\d+>", kname)
                launch_ms[m.group(0) if m else kname[:60]] = t / n
            row.update(cuda_core_ms=cc_ms, plain_ms=plain_ms,
                       bit_equal=same, registers=regs, device_ms=launch_ms)
            print(f"[train] flash_attention_bwd time B={B} S={S} H={H} "
                  f"Kv={Kv} hd={hd} {name} causal ({path}, "
                  f"{FA.BWD_LAUNCHES} launches): {ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}, {ms / bound:.1f}x){fp32_bound}; "
                  f"SDPA forward + backward ({backend}) {lib_ms:.3f} ms "
                  f"({lib_ms / ms:.2f}x the kernel's time); plain backward "
                  f"{plain_ms:.3f} ms; the CUDA-core pair it replaced "
                  f"{cc_ms:.3f} ms ({cc_ms / ms:.1f}x); two runs bit-equal "
                  f"{same}; device ms a launch (profiler): " + ", ".join(
                      f"{n} {t:.4f}" for n, t in launch_ms.items()) +
                  "; ptxas: " + "; ".join(
                      f"{n} {r}" for n, r in regs.items()))
            out[f"hd{hd}/{name}"] = row
            del q, k, v, do, o, lse, qt, kt, vt
            torch.cuda.empty_cache()
    return out


# the bf16 backward at hd 64 and 128 (the two-warpgroup pair, route wgmma)
# against its yardstick, the one-warpgroup pair it replaced: the training
# shapes at those widths (TRAIN_FLASH_SHAPES), qwen1.5-110b's prefill shape
# (B=4) and deepseek-moe-16b's training attention (the moe phase's
# microbatch of 4,096 tokens, 16 heads of 128, one query head a kv head)
PIPE_SHAPES = {**{arch: shape for arch, shape in TRAIN_FLASH_SHAPES.items()
                  if shape[4] in (64, 128)},
               "qwen1.5-110b prefill": (4, 1024, 64, 8, 128, True),
               "deepseek-moe-16b": (1, 4096, 16, 16, 128, True)}
# the training shapes whose G is here must run faster on the pair than on
# the yardstick; every other shape whose route runs a kernel the yardstick
# does not, no slower than the yardstick's slowest turn
PIPE_GATED_G = (7, 8)
# rounds of turns (yardstick, pair, pair, yardstick), each turn both
# launches of a pair timed by events (``bwd_launch_ms``); each pair's time
# is the median of its turns
PIPE_ROUNDS = 5
# calls a profiled window, and windows taken before a device time is given
# up as not recorded (the profiler loses a window's device trace, whole or
# its first events, now and then)
PIPE_REPS = 10
PIPE_TRIES = 6


def pipe_kernels(hd, G):
    """The kernels that the route's C functions launch for bf16 at hd 64 or
    128 with G query heads a kv head (``flash_bwd_dq_bf16``,
    ``flash_bwd_dkdv_bf16``), as (dq, dk/dv); the profiler's names check
    it."""
    return (f"flash_bwd_dq_wgmma{'_pipe' if hd == 128 else ''}<{hd}>",
            f"flash_bwd_dkdv_wgmma{'_pipe' if G > 1 else ''}<{hd}>")


def yardstick_bwd(torch, FA, q, k, v, o, lse, do, causal=True, window=0):
    """The one-warpgroup bf16 pair (``flash_bwd_dq_wgmma``, then
    ``flash_bwd_dkdv_wgmma``) through its C functions
    (``flash_bwd_dq_bf16_yardstick``, ``flash_bwd_dkdv_bf16_yardstick``) at
    hd 64 or 128, for comparison and timing beside the two-warpgroup pair
    that replaced it on the route. Returns (dq, dk, dv)."""
    from repro_torch.kernels import build as kbuild
    B, S, H, hd = q.shape
    # allocated as the wrapper allocates (no fill under deterministic mode)
    dq, dk, dv = (kbuild.empty_like(t) for t in (q, k, v))
    dsum = kbuild.empty(B, H, S, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    for fn, ptrs in zip(FA.build_bwd()[torch.bfloat16, "wgmma_yardstick"],
                        ((q, k, v, o, do, lse, dsum, dq),
                         (q, k, v, do, lse, dsum, dk, dv))):
        err = fn(*(t.data_ptr() for t in ptrs), B, S, H, k.shape[2], hd,
                 int(causal), window, 1.0 / math.sqrt(hd), stream)
        check(err == 0, f"the one-warpgroup bf16 backward pair failed to "
                        f"launch: {err}")
    return dq, dk, dv


def bwd_launch_ms(torch, FA, key, q, k, v, o, lse, do, causal):
    """The dq launch and the dk/dv launch of the bf16 C functions ``key``
    (``wgmma``: the route's; ``wgmma_yardstick``) timed apart, each by CUDA
    events over back-to-back launches of it alone (dk/dv reading the D of
    one dq launch before), no Python wrapper around them: (dq ms, dk/dv ms)
    a launch."""
    from repro_torch.kernels import build as kbuild
    B, S, H, hd = q.shape
    dq, dk, dv = (kbuild.empty_like(t) for t in (q, k, v))
    dsum = kbuild.empty(B, H, S, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    fns = FA.build_bwd()[torch.bfloat16, key]
    calls = [(fn, [t.data_ptr() for t in ptrs]) for fn, ptrs in zip(
        fns, ((q, k, v, o, do, lse, dsum, dq),
              (q, k, v, do, lse, dsum, dk, dv)))]
    out = []
    for fn, ptrs in calls:
        def launch(fn=fn, ptrs=ptrs):
            err = fn(*ptrs, B, S, H, k.shape[2], hd, int(causal), 0,
                     1.0 / math.sqrt(hd), stream)
            check(err == 0, f"{key}: a backward launch failed: {err}")
        out.append(median_ms(launch, torch, reps=10, inner=5, warm=3))
    return tuple(out)


def device_ms_a_call(torch, fn):
    """Device ms a call of ``fn`` and {kernel: (ms a launch, launches a
    call)} from a profiled window of PIPE_REPS calls: each kernel's launches
    a call are its launches in the window over PIPE_REPS, rounded (a kernel
    launched once a window, such as a first call's set-up, rounds to none),
    its ms a launch the mean over the launches recorded, so a window whose
    first few device events the profiler lost still gives the call's time.
    Up to PIPE_TRIES windows while one records no event, else (None, {}):
    not recorded."""
    for attempt in range(PIPE_TRIES):
        by_name = profiled(torch, fn, reps=PIPE_REPS)[3]
        per_call = {name: (t / n, round(n / PIPE_REPS))
                    for name, (n, t) in by_name.items()
                    if round(n / PIPE_REPS)}
        if per_call:
            return sum(t * c for t, c in per_call.values()), per_call
        print(f"[profile] window {attempt + 1} of {PIPE_TRIES} recorded no "
              f"kernel launched every call; taken again")
    return None, {}


def flash_bwd_pipe_times(torch, FA, ref):
    """The bf16 backward at hd 64 and 128 at ``PIPE_SHAPES``, from the
    kernel forward's out and lse: the two-warpgroup pair (the route) and
    its yardstick (``yardstick_bwd``) each against the plain backward
    within TRAIN_GRAD_TOL of max |grad|, two runs of each bit for bit
    equal; both timed in turns (yardstick, pair, pair, yardstick;
    ``bwd_launch_ms``, PIPE_ROUNDS rounds, the median of each pair's
    turns), dq and dk/dv apart; the profiler's device time of each launch,
    its kernels' names (held to ``pipe_kernels``), the kernel forward with
    lse and SDPA's forward and its backward alone (``torch.autograd.grad``
    of one forward's output, timed only), where a window recorded them;
    beside the bound and the plain backward. Gated: at the training shapes
    whose G is in PIPE_GATED_G the pair's median below the yardstick's; at
    every other shape where the route runs a kernel the yardstick does
    not, the pair's median at most the yardstick's slowest turn. Returns a
    row a shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    out = {}
    for arch, (B, S, H, Kv, hd, causal) in PIPE_SHAPES.items():
        G = H // Kv
        q, k, v, do = (randn(torch, (B, S, n, hd), torch.bfloat16, 240 + j)
                       for j, n in enumerate((H, Kv, Kv, H)))
        o, lse = FA.flash_attention(q, k, v, causal=causal, with_lse=True)
        before = FA.flash_attention_bwd.route_launches["wgmma"]
        new = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        check(FA.flash_attention_bwd.route_launches["wgmma"] - before ==
              FA.BWD_LAUNCHES, f"{arch}: the backward did not run on wgmma")
        new2 = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        old = yardstick_bwd(torch, FA, q, k, v, o, lse, do, causal)
        old2 = yardstick_bwd(torch, FA, q, k, v, o, lse, do, causal)
        want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       chunk=min(ops.KV_CHUNK, S))
        errs = [rel_err(torch, a, b) for a, b in zip(new, want)]
        errs_old = [rel_err(torch, a, b) for a, b in zip(old, want)]
        abs_err, abs_err_old = (max(
            (a.float() - b.float()).abs().max().item()
            for a, b in zip(got, want)) for got in (new, old))
        same = all(torch.equal(a, b) for a, b in zip(new, new2))
        same_old = all(torch.equal(a, b) for a, b in zip(old, old2))
        del new, new2, old, old2, want
        tag = (f"{arch} B={B} S={S} H={H} Kv={Kv} (G = {G}) hd={hd} "
               f"{'causal' if causal else 'non-causal'}")
        ok = max(errs) <= TRAIN_GRAD_TOL and max(errs_old) <= TRAIN_GRAD_TOL
        print(f"[train] flash backward pair (two warpgroups) and yardstick "
              f"(one) at {tag}: max|kernel-plain| / max|grad| dq/dk/dv "
              f"{'/'.join(f'{e:.3e}' for e in errs)} (yardstick "
              f"{'/'.join(f'{e:.3e}' for e in errs_old)}), tol "
              f"{TRAIN_GRAD_TOL}; two runs bit-equal {same} (yardstick "
              f"{same_old}) {'ok' if ok and same and same_old else 'FAIL'}")
        check(ok and same and same_old,
              f"{arch}: the hd-{hd} backward pairs disagree with the plain "
              f"backward or between runs")
        keys = {"yardstick": "wgmma_yardstick", "pair": "wgmma"}
        names = {"yardstick": (f"flash_bwd_dq_wgmma<{hd}>",
                               f"flash_bwd_dkdv_wgmma<{hd}>"),
                 "pair": pipe_kernels(hd, G)}
        turns = {"yardstick": [], "pair": []}
        each = {"yardstick": [], "pair": []}
        for name in ("yardstick", "pair", "pair", "yardstick") * PIPE_ROUNDS:
            t = bwd_launch_ms(torch, FA, keys[name], q, k, v, o, lse, do,
                              causal)
            turns[name].append(sum(t))
            each[name].append(t)
        ms = {name: statistics.median(t) for name, t in turns.items()}
        launch_ms = {name: {n: statistics.median(t[i] for t in each[name])
                            for i, n in enumerate(names[name])}
                     for name in names}
        runs = {"yardstick": lambda: yardstick_bwd(torch, FA, q, k, v, o, lse,
                                                   do, causal),
                "pair": lambda: FA.flash_attention_bwd(q, k, v, o, lse, do,
                                                       causal=causal)}
        # the profiler: each launch's device time and the kernels' names
        device_ms, device_launch_ms = {}, {}
        for name, fn in runs.items():
            call_ms, per_call = device_ms_a_call(torch, fn)
            hits = {}
            for kname, (t, c) in per_call.items():
                m = re.search(r"flash_bwd_\w+<\d+>", kname)
                if m:
                    hits[m.group(0)] = (t, c)
            check(call_ms is None or (
                set(hits) == set(names[name]) and
                all(c == 1 for _, c in hits.values())),
                  f"{arch}: the {name} ran {hits} a call, not one launch of "
                  f"each of {list(names[name])}")
            device_ms[name] = call_ms
            device_launch_ms[name] = {n: t for n, (t, _) in hits.items()}
        wall_ms = median_ms(runs["pair"], torch, reps=10, inner=5, warm=5)
        fwd_ms = device_ms_a_call(torch, lambda: FA.flash_attention(
            q, k, v, causal=causal, with_lse=True))[0]
        plain_ms = median_ms(lambda: ref.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, chunk=min(ops.KV_CHUNK, S)),
            torch, reps=2, inner=1, warm=1)
        qt, kt, vt = (t.detach().clone().requires_grad_() for t in (q, k, v))
        dy = do.transpose(1, 2)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
                is_causal=causal, enable_gqa=True)

        # SDPA's backward kernels are not all deterministic: timed with the
        # switch off, used nowhere in the port
        torch.use_deterministic_algorithms(False)
        try:
            y = sdpa_fwd()

            def sdpa_bwd():
                torch.autograd.grad(y, (qt, kt, vt), dy, retain_graph=True)

            sdpa_bwd()
            lib_fwd_ms, lib_bwd_ms = (device_ms_a_call(torch, fn)[0]
                                      for fn in (sdpa_fwd, sdpa_bwd))
            # its backward by events too (host time included)
            lib_bwd_wall_ms = median_ms(sdpa_bwd, torch, reps=10, inner=5,
                                        warm=3)
            backend = sdpa_backend(torch, sdpa(torch, q, k, v, causal))
            del y
        finally:
            torch.use_deterministic_algorithms(True)
        bound, by = flash_bwd_bound_ms(B, S, H, Kv, hd, causal=causal)
        timed = None not in (fwd_ms, device_ms["pair"], lib_fwd_ms,
                             lib_bwd_ms)
        lib_ms = lib_fwd_ms + lib_bwd_ms if timed else None
        fwd_bwd_ms = fwd_ms + device_ms["pair"] if timed else None
        print(f"[train] flash backward time at {tag} (events, each launch "
              f"alone, ms a call): the pair "
              f"{'/'.join(f'{t:.4f}' for t in turns['pair'])}, the yardstick "
              f"{'/'.join(f'{t:.4f}' for t in turns['yardstick'])} (in "
              f"turns; {ms['yardstick'] / ms['pair']:.2f}x); bound "
              f"{bound:.4f} ms ({by}, the pair {ms['pair'] / bound:.2f}x); "
              f"the pair through the wrapper {wall_ms:.4f} ms; plain "
              f"backward {plain_ms:.3f} ms; device ms a call (profiler): the "
              f"pair {fmt_ms(device_ms['pair'])}, the yardstick "
              f"{fmt_ms(device_ms['yardstick'])}, SDPA's backward alone "
              f"({backend}) {fmt_ms(lib_bwd_ms)} (by events, host included, "
              f"{lib_bwd_wall_ms:.4f} ms), the forward with lse "
              f"{fmt_ms(fwd_ms)}, forward + the pair {fmt_ms(fwd_bwd_ms)} "
              f"against SDPA's forward + backward {fmt_ms(lib_ms)}: " +
              ("not measured" if not timed else "faster" if fwd_bwd_ms <
               lib_ms else "slower") +
              "; ms a launch (events): " + "; ".join(
                  f"{w} " + ", ".join(f"{n} {t:.4f}" for n, t in d.items())
                  for w, d in launch_ms.items()) +
              "; device ms a launch (profiler): " + "; ".join(
                  f"{w} " + (", ".join(f"{n} {t:.4f}" for n, t in d.items())
                             or "not recorded")
                  for w, d in device_launch_ms.items()))
        if arch in TRAIN_FLASH_SHAPES and G in PIPE_GATED_G:
            gate = "faster"
            check(ms["pair"] < ms["yardstick"],
                  f"{arch}: the two-warpgroup backward ({ms['pair']:.4f} ms) "
                  f"is not faster than the one-warpgroup pair "
                  f"({ms['yardstick']:.4f} ms)")
        elif names["pair"] != names["yardstick"]:
            gate = "no slower than the yardstick's slowest turn"
            check(ms["pair"] <= max(turns["yardstick"]),
                  f"{arch}: the backward on {names['pair']} "
                  f"({ms['pair']:.4f} ms) is slower than the one-warpgroup "
                  f"pair's slowest turn ({max(turns['yardstick']):.4f} ms)")
        else:
            gate = "none: the route runs the yardstick's kernels"
        print(f"[train] flash backward gate at {arch}: {gate} ok")
        out[arch] = dict(shape=[B, S, H, Kv, hd, causal], err=errs,
                         yardstick_err=errs_old, max_abs_err=abs_err,
                         yardstick_abs_err=abs_err_old,
                         bit_equal=same, ms=ms["pair"],
                         yardstick_ms=ms["yardstick"], turns=turns,
                         launch_ms=launch_ms["pair"],
                         yardstick_launch_ms=launch_ms["yardstick"],
                         device_ms=device_ms["pair"],
                         yardstick_device_ms=device_ms["yardstick"],
                         device_launch_ms=device_launch_ms["pair"],
                         yardstick_device_launch_ms=device_launch_ms[
                             "yardstick"],
                         gate=gate, wall_ms=wall_ms,
                         bound_ms=bound, bound_by=by, plain_ms=plain_ms,
                         fwd_lse_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms,
                         sdpa_fwd_ms=lib_fwd_ms, sdpa_bwd_ms=lib_bwd_ms,
                         sdpa_bwd_wall_ms=lib_bwd_wall_ms,
                         sdpa_fwd_bwd_ms=lib_ms, sdpa_backend=backend)
        del q, k, v, do, o, lse, qt, kt, vt, dy
        torch.cuda.empty_cache()
    return out


def fwd_launcher(torch, FA, key, q, k, v, out, lse, causal):
    """One launch of the bf16 forward C function ``key`` (``wgmma``: the
    route's; ``wgmma_yardstick``) on q, k, v into out (and lse, if not
    None), with no Python wrapper around it: for timing."""
    B, S, H, hd = q.shape
    fn = FA.build()[torch.bfloat16, key]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, S, H, k.shape[2], hd,
            int(causal), 0, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*args)
        check(err == 0, f"{FA._FNS[torch.bfloat16, key]} launch failed: "
                        f"{err}")
    return launch


def flash_fwd_pipe_times(torch, FA, ref):
    """The bf16 forward at hd 64 and 128 at ``FWD_PIPE_SHAPES``: the route
    (``fwd_pipe_kernel``) and its yardstick flash_kernel_wgmma<HD, 64>
    (``fwd_yardstick``) each held against the plain version at the qwen
    gate with inputs x0.5 and x2, lse within TRAIN_LSE_TOL, two runs of the
    route bit-equal, and the route bit-equal to the yardstick where
    ``fwd_pipe_bit_equal``; both timed in turns (yardstick, route, route,
    yardstick; PIPE_ROUNDS rounds of CUDA events over launches of the C
    functions alone, ``fwd_launcher``; the median of each one's turns),
    with lse where the shape's path writes it; the profiler's device time
    a call of each, its kernel's name and one launch a call held to what
    the route should run, SDPA's forward by device time (and by events),
    the plain version, and the bound by two products (the function's) and
    by three (the kernels' P_hi V + P_lo V). Gated: at FWD_PIPE_FASTER the
    route's median below the yardstick's, at every other shape at most the
    yardstick's slowest turn. Returns a row a shape."""
    from repro_torch.kernels import build as kbuild
    rtol, atol = TOL["bfloat16"], QWEN_FLASH_BF16_ATOL
    lrtol, latol = TRAIN_LSE_TOL
    out = {}
    for name, (B, S, H, Kv, hd, causal, with_lse) in FWD_PIPE_SHAPES.items():
        G = H // Kv
        kname = fwd_pipe_kernel(hd, G)
        yname = f"flash_kernel_wgmma<{hd}, 64>"
        tag = (f"{name} B={B} S={S} H={H} Kv={Kv} (G = {G}) hd={hd} "
               f"{'causal' if causal else 'non-causal'}")
        errs, yard_errs, lse_errs = [], [], []
        same = yard_same = True
        for j, scale in enumerate(QWEN_FLASH_SCALES[::-1]):
            # x2 first; the x0.5 inputs stay for the timing
            q, k, v = (randn(torch, (B, S, n, hd), torch.bfloat16, 400 + i,
                             scale) for i, n in enumerate((H, Kv, Kv)))
            got, lse = FA.flash_attention(q, k, v, causal=causal,
                                          with_lse=True)
            again, lse2 = FA.flash_attention(q, k, v, causal=causal,
                                             with_lse=True)
            yard, ylse = fwd_yardstick(torch, FA, q, k, v, True, causal)
            want, plse = ref.flash_attention(q, k, v, causal=causal,
                                             with_lse=True)
            what = f"flash_attention {tag} inputs x{scale} bfloat16"
            errs.append(held(torch, f"{what} ({kname})", got, want, rtol,
                             atol))
            yard_errs.append(held(torch, f"{what} ({yname}, the yardstick)",
                                  yard, want, rtol, atol))
            lse_errs.append((lse - plse).abs().max().item())
            check(bool(((lse - plse).abs() <=
                        lrtol * plse.abs() + latol).all()),
                  f"{what}: lse off by {lse_errs[-1]:.3e}")
            same &= torch.equal(got, again) and torch.equal(lse, lse2)
            yard_same &= torch.equal(got, yard) and torch.equal(lse, ylse)
            del got, again, lse, lse2, yard, ylse, want, plse
            if j == 0:
                del q, k, v
        check(same, f"{tag}: two runs of {kname} differ")
        gate_bits = fwd_pipe_bit_equal(hd, G)
        check(yard_same or not gate_bits,
              f"{tag}: {kname} is not bit-equal to {yname}, whose order of "
              f"sums it keeps")
        o = kbuild.empty_like(q)
        lse_buf = kbuild.empty(B, H, S, dtype=torch.float32,
                               device=q.device) if with_lse else None
        launch = {who: fwd_launcher(torch, FA, key, q, k, v, o, lse_buf,
                                    causal)
                  for who, key in (("route", "wgmma"),
                                   ("yardstick", "wgmma_yardstick"))}
        turns = {"yardstick": [], "route": []}
        for who in ("yardstick", "route", "route", "yardstick") * PIPE_ROUNDS:
            turns[who].append(median_ms(launch[who], torch, reps=10, inner=5,
                                        warm=3))
        ms = {who: statistics.median(t) for who, t in turns.items()}
        # a window that never records leaves the call's kernel unchecked
        # here and its time "not measured"; the shape is listed in the
        # kernels line (``unrecorded``)
        device = {}
        for who, kern in (("route", kname), ("yardstick", yname)):
            call_ms, per_call = device_ms_a_call(torch, launch[who])
            hits = {fwd_name(n_) or n_: c for n_, (_, c) in per_call.items()}
            if call_ms is None:
                print(f"[profile] {tag}: no window recorded the {who}: its "
                      f"device time not measured, its kernel not checked")
            check(call_ms is None or hits == {kern: 1},
                  f"{tag}: the {who} ran {hits} a call, not one launch of "
                  f"{kern}")
            device[who] = call_ms
        plain_ms = median_ms(lambda: ref.flash_attention(
            q, k, v, causal=causal, with_lse=with_lse), torch, reps=2,
            inner=1, warm=1)
        torch.use_deterministic_algorithms(False)
        try:
            lib = sdpa(torch, q, k, v, causal)
            backend = sdpa_backend(torch, lib)
            lib_ms = device_ms_a_call(torch, lib)[0]
            lib_event_ms = median_ms(lib, torch, reps=10, inner=5, warm=3)
        finally:
            torch.use_deterministic_algorithms(True)
        bound, by = flash_bound_ms(B, S, H, Kv, hd, 2, causal=causal)
        bound3, by3 = flash_bound_ms(B, S, H, Kv, hd, 2, causal=causal,
                                     products=3)
        print(f"[kernel] flash forward time at {tag} "
              f"{'with' if with_lse else 'without'} lse (events, C functions "
              f"alone, ms a call): {kname} "
              f"{'/'.join(f'{t:.4f}' for t in turns['route'])}, {yname} "
              f"{'/'.join(f'{t:.4f}' for t in turns['yardstick'])} (in "
              f"turns; {ms['yardstick'] / ms['route']:.3f}x); device ms a "
              f"call (profiler): {fmt_ms(device['route'])} against "
              f"{fmt_ms(device['yardstick'])}; SDPA's forward ({backend}) "
              f"{fmt_ms(lib_ms)} ({lib_event_ms:.4f} ms by events); plain "
              f"{plain_ms:.3f} ms; bound {bound:.4f} ms ({by}), by three "
              f"products {bound3:.4f} ms ({by3}; the route "
              f"{100 * bound3 / ms['route']:.1f}% of it); max|kernel-plain| "
              f"{max(errs):.3e} (yardstick {max(yard_errs):.3e}), lse "
              f"{max(lse_errs):.2e}; two runs bit-equal; bit-equal to the "
              f"yardstick {yard_same} (" + ("gated" if gate_bits else
                                            "not gated: G does not divide "
                                            "the block's rows") + ")")
        if kname == yname:
            gate = "none: the route runs the yardstick's kernel"
        elif name in FWD_PIPE_FASTER:
            gate = "faster than the yardstick's median"
            check(ms["route"] < ms["yardstick"],
                  f"{tag}: {kname} ({ms['route']:.4f} ms) is not faster "
                  f"than {yname} ({ms['yardstick']:.4f} ms)")
        else:
            gate = "no slower than the yardstick's slowest turn"
            check(ms["route"] <= max(turns["yardstick"]),
                  f"{tag}: {kname} ({ms['route']:.4f} ms) is slower than "
                  f"{yname}'s slowest turn ({max(turns['yardstick']):.4f} "
                  f"ms)")
        print(f"[kernel] flash forward gate at {name}: {gate} ok")
        out[name] = dict(shape=[B, S, H, Kv, hd, causal], with_lse=with_lse,
                         kernel=kname, yardstick=yname, ms=ms["route"],
                         yardstick_ms=ms["yardstick"], turns=turns,
                         device_ms=device["route"],
                         yardstick_device_ms=device["yardstick"],
                         sdpa_fwd_ms=lib_ms, sdpa_fwd_event_ms=lib_event_ms,
                         sdpa_backend=backend, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, bound3_ms=bound3,
                         bound3_by=by3, max_abs_err=max(errs),
                         yardstick_err=max(yard_errs),
                         lse_err=max(lse_errs), bit_equal=same,
                         bit_equal_to_yardstick=yard_same,
                         bit_equal_gated=gate_bits, gate=gate)
        del q, k, v, o, lse_buf
        torch.cuda.empty_cache()
    return out


# the column kernels under autograd: one ops.attention step at qwen's
# training attention (B=1, S=1,024, 64 over 8 heads) widened, bf16, causal
FLASH_BWD_AUTOGRAD = ((1, 1024, 64, 8, 576), (1, 1024, 64, 8, 1024))


def flash_bwd_autograd_cols(torch, FA):
    """One ``ops.attention`` (``FlashAttention``) step at each of
    FLASH_BWD_AUTOGRAD: the kernel forward's launch and the backward's two
    launches counted on ``wgmma_chunked`` (none elsewhere), the gradients
    within TRAIN_GRAD_TOL of max |grad| of the same step through the plain
    versions (``plain_kernels``). Returns the worst error by width."""
    from repro_torch.kernels import ops
    out = {}
    for B, S, H, Kv, hd in FLASH_BWD_AUTOGRAD:
        q, k, v, do = (randn(torch, (B, S, n, hd), torch.bfloat16, 230 + j)
                       for j, n in enumerate((H, Kv, Kv, H)))

        def attend(*xs):
            return ops.attention(*xs, causal=True)

        before = (dict(FA.flash_attention.route_launches),
                  dict(FA.flash_attention_bwd.route_launches))
        gk = grads_of(torch, attend, (q, k, v), do)
        torch.cuda.synchronize()
        fwd = {r: n - before[0][r]
               for r, n in FA.flash_attention.route_launches.items()}
        bwd = {r: n - before[1][r]
               for r, n in FA.flash_attention_bwd.route_launches.items()}
        with plain_kernels():
            gp = grads_of(torch, attend, (q, k, v), do)
        errs = [rel_err(torch, a, b) for a, b in zip(gk, gp)]
        want_fwd = dict.fromkeys(fwd, 0) | {"wgmma_chunked": 1}
        want_bwd = dict.fromkeys(bwd, 0) | {"wgmma_chunked": FA.BWD_LAUNCHES}
        ok = max(errs) <= TRAIN_GRAD_TOL
        print(f"[train] FlashAttention B={B} S={S} H={H} Kv={Kv} hd={hd} "
              f"bf16 causal, one step: launches forward {fwd}, backward "
              f"{bwd}; kernel vs plain forward + backward, max|diff| / "
              f"max|grad| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
              f"tol {TRAIN_GRAD_TOL} {'ok' if ok else 'FAIL'}")
        check(fwd == want_fwd and bwd == want_bwd,
              f"hd {hd}: the autograd step launched forward {fwd}, backward "
              f"{bwd}; expected {want_fwd}, {want_bwd}")
        check(ok, f"hd {hd}: FlashAttention's gradients through the column "
                  f"kernels disagree with the plain path")
        out[f"hd{hd}"] = max(errs)
        del q, k, v, do, gk, gp
        torch.cuda.empty_cache()
    return out


def phase_train_kernels(torch, FA, RN, ref):
    """The two kernels as the training path runs them, at full width:
    ``FlashAttention`` forward (the kernel, writing lse) and backward (the
    backward kernels) against the plain forward and backward on the card,
    over the JAX sweep and at the training shapes; ``RMSNorm`` forward and
    backward likewise. Times beside the bounds, the plain versions and
    SDPA's forward + backward."""
    import contextlib
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    out = {"bwd_sweep_err": flash_bwd_sweep(torch, FA, ref),
           "bwd_cc_err": flash_bwd_cc_gate(torch, FA, ref),
           "bwd_entry_s": flash_bwd_entry(torch, FA, ref),
           "bwd_wide": flash_bwd_wide_times(torch, FA, ref),
           "bwd_pipe": flash_bwd_pipe_times(torch, FA, ref),
           "bwd_autograd_cols": flash_bwd_autograd_cols(torch, FA)}
    for arch, (B, S, H, Kv, hd, causal) in TRAIN_FLASH_SHAPES.items():
        mask = "causal" if causal else "non-causal"
        q, k, v, do = (randn(torch, (B, S, n, hd), torch.bfloat16, 200 + j)
                       for j, n in enumerate((H, Kv, Kv, H)))
        before = (FA.flash_attention.launches,
                  FA.flash_attention.lse_launches)
        o, lse = FA.flash_attention(q, k, v, causal=causal, with_lse=True)
        po, plse = ref.flash_attention(q, k, v, causal=causal,
                                       with_lse=True)
        torch.cuda.synchronize()
        check((FA.flash_attention.launches - before[0],
               FA.flash_attention.lse_launches - before[1]) == (1, 1),
              "the lse launch was not counted")
        rtol, atol = TRAIN_LSE_TOL
        lse_err = (lse - plse).abs().max().item()
        lse_ok = bool(((lse - plse).abs() <=
                       rtol * plse.abs() + atol).all())
        print(f"[train] {arch} flash B={B} S={S} H={H} Kv={Kv} hd={hd} "
              f"bf16 {mask}: lse [B, H, S] max|kernel-plain| {lse_err:.3e} "
              f"(|lse| up to {plse.abs().max().item():.2f}; rtol {rtol} "
              f"atol {atol}) {'ok' if lse_ok else 'FAIL'}")
        check(lse_ok, f"{arch}: the kernel's lse disagrees with the plain "
                      f"lse")
        check(torch.equal(o, FA.flash_attention(q, k, v, causal=causal)),
              f"{arch}: out differs with and without lse")
        chunk = min(ops.KV_CHUNK, S)

        def attend(*xs):
            return ops.attention(*xs, causal=causal)

        gk = grads_of(torch, attend, (q, k, v), do)
        with plain_kernels():
            gp = grads_of(torch, attend, (q, k, v), do)
            g32 = grads_of(torch, attend, (q.float(), k.float(), v.float()),
                           do.float())
        errs = {}
        for name, a, b, c in zip(("dq", "dk", "dv"), gk, gp, g32):
            errs[name] = (rel_err(torch, a, b), rel_err(torch, b, c))
        ok = all(e[0] <= TRAIN_GRAD_TOL for e in errs.values())
        print(f"[train] {arch} FlashAttention, kernel forward + backward vs "
              f"plain forward + backward, max|diff| / max|grad|: " + ", ".join(
                  f"{n} {e[0]:.3e} (bf16 plain vs fp32 plain {e[1]:.3e})"
                  for n, e in errs.items()) +
              f"; tol {TRAIN_GRAD_TOL} {'ok' if ok else 'FAIL'}")
        check(ok, f"{arch}: flash gradients through the kernel disagree "
                  f"with the plain path")
        kb = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        pb = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     chunk=chunk)
        bwd_errs = [rel_err(torch, a, b) for a, b in zip(kb, pb)]
        bwd_abs = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(kb, pb))
        ok = max(bwd_errs) <= TRAIN_GRAD_TOL
        print(f"[train] {arch} flash_attention_bwd vs the plain backward, the "
              f"same out and lse: max|diff| / max|grad| dq {bwd_errs[0]:.3e} "
              f"dk {bwd_errs[1]:.3e} dv {bwd_errs[2]:.3e} (max|diff| "
              f"{bwd_abs:.3e}); tol {TRAIN_GRAD_TOL} {'ok' if ok else 'FAIL'}")
        check(ok, f"{arch}: the backward kernels disagree with the plain "
                  f"backward")
        # a thread whose first CUDA call is a kernel's tensor-map encode, as
        # autograd's worker thread is when its first node is the flash
        # backward
        fresh = in_fresh_thread(torch, lambda: (
            FA.flash_attention(q, k, v, causal=causal, with_lse=True),
            FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)))
        same = torch.equal(fresh[0][0], o) and \
            torch.equal(fresh[0][1], lse) and \
            all(torch.equal(a, b) for a, b in zip(fresh[1], kb))
        print(f"[train] {arch} the forward and the backward launched from a "
              f"fresh thread bit-equal to this thread's: {same}")
        check(same, f"{arch}: a fresh thread's launches differ")
        del kb, pb, fresh
        kbwd_ms = median_ms(lambda: FA.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), torch, reps=10, inner=5)
        qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def port_fb():
            torch.autograd.grad(attend(qa, ka, va), (qa, ka, va), do)

        fb_ms = median_ms(port_fb, torch, reps=10, inner=5)
        ms_lse = median_ms(lambda: FA.flash_attention(
            q, k, v, causal=causal, with_lse=True), torch, reps=10, inner=5)
        ms = median_ms(lambda: FA.flash_attention(q, k, v, causal=causal),
                       torch, reps=10, inner=5)
        yard, more = {}, ""
        if hd == 192:
            # flash_kernel_wgmma_pipe held at the qwen gate and timed in
            # turns beside flash_kernel_wgmma<192, 64> (its C function),
            # with and without lse, and beside SDPA's forward
            tag = f"{arch} B={B} S={S} H={H} Kv={Kv} hd={hd} causal bfloat16"
            yard["max_abs_err"] = held(
                torch, f"flash_attention {tag} (wgmma, "
                f"flash_kernel_wgmma_pipe)", o, po, TOL["bfloat16"],
                QWEN_FLASH_BF16_ATOL)
            yard["yardstick_err"] = held(
                torch, f"flash_kernel_wgmma<192, 64> {tag} (the yardstick)",
                fwd_yardstick(torch, FA, q, k, v), po, TOL["bfloat16"],
                QWEN_FLASH_BF16_ATOL)
            turns = [median_ms(fn, torch, reps=10, inner=5) for fn in (
                lambda: fwd_yardstick(torch, FA, q, k, v, with_lse=True),
                lambda: FA.flash_attention(q, k, v, with_lse=True),
                lambda: fwd_yardstick(torch, FA, q, k, v),
                lambda: FA.flash_attention(q, k, v))]
            yard.update(yardstick_lse_ms=turns[0], yardstick_ms=turns[2])
            ms_lse, ms = turns[1], turns[3]
            check(ms_lse < turns[0] and ms < turns[2],
                  f"{arch}: flash_kernel_wgmma_pipe ({ms_lse:.4f} / {ms:.4f} "
                  f"ms with / without lse) is not faster than "
                  f"flash_kernel_wgmma<192, 64> ({turns[0]:.4f} / "
                  f"{turns[2]:.4f} ms)")
            torch.use_deterministic_algorithms(False)
            try:
                fwd_lib = sdpa(torch, q, k, v)
                yard["sdpa_fwd_ms"] = median_ms(fwd_lib, torch, reps=10,
                                                inner=5)
                yard["sdpa_fwd_backend"] = sdpa_backend(torch, fwd_lib)
            finally:
                torch.use_deterministic_algorithms(True)
            more = (f"; flash_kernel_wgmma<192, 64> {turns[0]:.4f} ms with "
                    f"lse ({turns[2]:.4f} without), SDPA forward "
                    f"({yard['sdpa_fwd_backend']}) {yard['sdpa_fwd_ms']:.4f} "
                    f"ms")
        bwd_ms = median_ms(lambda: ref.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, chunk=chunk), torch, reps=3,
            inner=2)
        plain_ms = median_ms(lambda: ref.flash_attention(
            q, k, v, causal=causal, with_lse=True), torch, reps=3, inner=2)
        fwd_bound, fwd_by = flash_bound_ms(B, S, H, Kv, hd, 2, causal=causal)
        fwd_bound = max(fwd_bound, 4 * B * H * S / PEAK_BYTES_S * 1e3)
        bwd_bound, bwd_by = flash_bwd_bound_ms(B, S, H, Kv, hd,
                                               causal=causal)
        qt, kt, vt = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def sdpa_fb():
            y = F.scaled_dot_product_attention(
                qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
                is_causal=causal, enable_gqa=True)
            torch.autograd.grad(y, (qt, kt, vt), do.transpose(1, 2))

        # SDPA's backward kernels are not all deterministic: timed with the
        # switch off, used nowhere in the port
        torch.use_deterministic_algorithms(False)
        try:
            lib_ms = median_ms(sdpa_fb, torch, reps=5, inner=3)
            lib_backend = sdpa_backend(torch, sdpa(torch, q, k, v, causal))
        finally:
            torch.use_deterministic_algorithms(True)
        regs = bwd_registers(FA, hd)
        print(f"[train] {arch} flash times ({mask}): forward with lse "
              f"{ms_lse:.4f} "
              f"ms (without lse {ms:.4f} ms; bound {fwd_bound:.4f} ms, "
              f"{fwd_by}), plain forward with lse {plain_ms:.3f} ms; backward "
              f"kernels {kbwd_ms:.4f} ms ({FA.BWD_LAUNCHES} launches, "
              f"{FA.bwd_route(q.dtype, hd)}; bound {bwd_bound:.4f} ms, "
              f"{bwd_by}; {kbwd_ms / bwd_bound:.2f}x), plain backward "
              f"{bwd_ms:.3f} ms; FlashAttention forward + backward "
              f"{fb_ms:.4f} ms, SDPA forward + backward ({lib_backend}) "
              f"{lib_ms:.4f} ms{more}; ptxas: " + "; ".join(
                  f"{n} {r}" for n, r in regs.items()))
        out[arch] = dict(shape=[B, S, H, Kv, hd, causal], lse_err=lse_err,
                         grad_err={n: e[0] for n, e in errs.items()},
                         grad_noise={n: e[1] for n, e in errs.items()},
                         bwd_err=bwd_errs, bwd_abs_err=bwd_abs,
                         fwd_lse_ms=ms_lse, fwd_ms=ms, fwd_bound_ms=fwd_bound,
                         bwd_ms=kbwd_ms, bwd_plain_ms=bwd_ms,
                         bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by,
                         fwd_bwd_ms=fb_ms, plain_fwd_ms=plain_ms,
                         sdpa_fwd_bwd_ms=lib_ms, sdpa_backend=lib_backend,
                         bwd_registers=regs, **yard)
        del q, k, v, do, o, lse, po, plse, gk, gp, g32, qt, kt, vt, qa, ka, va
        torch.cuda.empty_cache()

    out["lse_routes"] = {}
    for B, S, H, Kv, hd, dt, path in TRAIN_LSE_ROUTES:
        dtype = getattr(torch, dt)
        q, k, v = (randn(torch, (B, S, n, hd), dtype, 220 + j)
                   for j, n in enumerate((H, Kv, Kv)))
        check(FA.route(dtype, hd, S, H // Kv) == path,
              f"hd {hd} {dt} does not route to {path}")
        before = (FA.flash_attention.route_launches[path],
                  FA.flash_attention.lse_launches)
        o, lse = FA.flash_attention(q, k, v, with_lse=True)
        po, plse = ref.flash_attention(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        check((FA.flash_attention.route_launches[path] - before[0],
               FA.flash_attention.lse_launches - before[1]) == (1, 1),
              f"the {path} lse launch was not counted")
        rtol, atol = TRAIN_LSE_TOL
        lse_err = (lse - plse).abs().max().item()
        lse_ok = bool(((lse - plse).abs() <=
                       rtol * plse.abs() + atol).all())
        print(f"[train] {path} flash B={B} S={S} H={H} Kv={Kv} hd={hd} {dt} "
              f"causal: lse [B, H, S] max|kernel-plain| {lse_err:.3e} "
              f"(|lse| up to {plse.abs().max().item():.2f}; rtol {rtol} "
              f"atol {atol}) {'ok' if lse_ok else 'FAIL'}")
        check(lse_ok, f"{path} hd {hd} {dt}: the kernel's lse disagrees "
                      f"with the plain lse")
        check(torch.equal(o, FA.flash_attention(q, k, v)),
              f"{path} hd {hd} {dt}: out differs with and without lse")
        out["lse_routes"][f"{path}/hd{hd}/{dt}"] = lse_err

    rows, d = TRAIN_RMS_SHAPE
    x = randn(torch, (rows, d), torch.bfloat16, 210)
    s = randn(torch, (d,), torch.bfloat16, 211, 0.1) + 1
    dy = randn(torch, (rows, d), torch.bfloat16, 212)

    def norm(x_, s_):
        return ops.rms_norm(x_, s_, 1e-6)

    before = (RN.rmsnorm.launches, RN.rmsnorm_bwd.launches)
    yk = norm(x, s)
    gk = grads_of(torch, norm, (x, s), dy)
    check((RN.rmsnorm.launches - before[0],
           RN.rmsnorm_bwd.launches - before[1]) == (2, RN.BWD_LAUNCHES),
          "RMSNorm did not launch its forward and backward kernels")
    with plain_kernels():
        yp = norm(x, s)
        gp = grads_of(torch, norm, (x, s), dy)
    errs = [rel_err(torch, a, b) for a, b in zip((yk, *gk), (yp, *gp))]
    ok = all(e <= TOL["bfloat16"] for e in errs)
    print(f"[train] RMSNorm [{rows}, {d}] bf16 forward + backward, the "
          f"kernels (forward, backward) vs plain, max|diff| / max|value|: y "
          f"{errs[0]:.3e}, dx {errs[1]:.3e}, dscale {errs[2]:.3e}; tol "
          f"{TOL['bfloat16']} {'ok' if ok else 'FAIL'} (times: the "
          f"rmsnorm_bwd phase)")
    check(ok, "RMSNorm gradients through the kernels disagree with the "
              "plain path")
    out["rmsnorm"] = dict(shape=[rows, d], errs=errs)
    return out


# kernels of a profiled training step by kind, first match wins
TRAIN_KERNEL_KINDS = (
    ("flash_kernel_wgmma", r"flash_kernel"),
    ("flash backward (flash_bwd_dq/dkdv_wgmma)", r"flash_bwd"),
    ("rmsnorm forward and backward", r"rmsnorm"),
    ("sort, index, scatter, gather (moe dispatch, embedding, the loss)",
     r"[Ss]ort|[Rr]adix|[Ii]ndex|[Ss]catter|[Gg]ather"),
    ("fp32 GEMMs (the fp32 logits)", r"f32f32_f32f32|sgemm"),
    ("bf16 GEMMs", r"bf16|nvjet|gemm"),
    ("NaN fills (deterministic mode)", r"[Ff]ill"),
    ("other", r""))


def train_profile(torch, fn, fwd_want, annotations=(), tries=2):
    """One call of ``fn`` (a training step's gradients) under
    ``torch.profiler``: window and device busy ms, kernel count, device ms
    by kind (``TRAIN_KERNEL_KINDS``) and the device ms under the plain
    flash backward's autograd node (the backward kernels); prints the top
    kernels; holds the flash forward's kernels to ``fwd_want`` ({name:
    launches}). ``annotations`` names ``record_function`` spans (``spans``):
    their device annotations are not counted as kernels, and ``under``
    holds, for each, the device ms of the kernels that start inside one of
    its spans. A window whose trace the profiler lost (``profiled``) is
    taken again, up to ``tries`` times. Returns them with fn's result under
    ``out`` and the seconds the profiler took to hand its events over
    (``parse_s``)."""
    import bisect
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        torch.cuda.synchronize()
        before = flash_fwd_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        t_parse = time.perf_counter()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        parse_s = time.perf_counter() - t_parse
        kernels = [e for e in device if e.name not in annotations]
        lost = lost_launches(kernels, flash_fwd_launches() - before)
        if kernels and not lost:
            break
        print(f"[profile] the training step's window {attempt + 1} of "
              f"{tries} recorded {lost or 'no kernel'}; taken again")
    under = {}
    for name in annotations:
        ranges = sorted((e.time_range.start, e.time_range.end)
                        for e in device if e.name == name)
        starts = [a for a, _ in ranges]
        under[name] = 0.0
        for e in kernels:
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start < ranges[i][1]:
                under[name] += e.time_range.elapsed_us() / 1e3
    check(bool(kernels), "the profiled training step recorded no kernel")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(t for _, t in by_name.values())
    kinds = dict.fromkeys((k for k, _ in TRAIN_KERNEL_KINDS), 0.0)
    for name, (_, t) in by_name.items():
        kind = next(k for k, pat in TRAIN_KERNEL_KINDS if re.search(pat, name))
        kinds[kind] += t
    bwd_ms = sum(getattr(e, "device_time_total", 0.0) for e in
                 prof.key_averages() if e.key == "FlashAttentionBackward")
    bwd_ms /= 1e3
    # the flash forward's kernels (flash_kernel*) by name
    fwd = [(n, t) for name, (n, t) in by_name.items()
           if "flash_kernel" in name]
    fwd_names = check_fwd_kernels("one training step's gradients", by_name,
                                  fwd_want)
    print(f"[profile] one training step's gradients: window {window_ms:.1f} "
          f"ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / window_ms:.1f}%), {len(kernels)} kernels; "
          f"under FlashAttentionBackward (the backward kernels) "
          f"{bwd_ms:.1f} ms "
          f"of device time ({100 * bwd_ms / window_ms:.1f}% of the window); "
          f"by kind: " + ", ".join(f"{k} {t:.1f} ms" for k, t in
                                   kinds.items()))
    for name, (cnt, t) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][1])[:12]:
        print(f"[profile]   {t:.2f} ms in {cnt} x {name[:100]}")
    rms_bwd = [(n, t) for name, (n, t) in by_name.items()
               if "rmsnorm_bwd" in name]
    # the backward kernels one by one (flash: by kernel and width; rmsnorm:
    # by kernel, its instantiations together): launches, ms, ms a launch
    apart = {}
    for name, (n, t) in by_name.items():
        m = re.search(r"flash_bwd_\w+<\d+>|rmsnorm_bwd_\w+_kernel", name)
        if m:
            a, b = apart.get(m.group(0), (0, 0.0))
            apart[m.group(0)] = (a + n, b + t)
    apart = {k: dict(launches=n, ms=t, ms_per_launch=t / n)
             for k, (n, t) in sorted(apart.items())}
    print("[profile]   backward kernels, device ms a launch: " + ", ".join(
        f"{k} {v['ms_per_launch']:.4f} ({v['launches']} launches, "
        f"{v['ms']:.2f} ms)" for k, v in apart.items()))
    return dict(out=out, window_ms=window_ms, busy_ms=busy_ms, under=under,
                parse_s=parse_s,
                kernels=len(kernels), kinds=kinds, flash_bwd_ms=bwd_ms,
                flash_fwd_ms=sum(t for _, t in fwd),
                flash_fwd_launches=sum(n for n, _ in fwd),
                fwd_kernels=fwd_names,
                rmsnorm_bwd_ms=sum(t for _, t in rms_bwd),
                rmsnorm_bwd_launches=sum(n for n, _ in rms_bwd),
                bwd_kernels=apart)


def model_flops(n_params, tokens, layers, heads, hd, seq):
    """A step's model FLOPs: 6 per parameter per token, plus causal
    attention's products (forward 2, backward 4 of the S/2 visible keys a
    query, 2 flops a multiply-add, per head and layer). Remat's recomputed
    forward is not counted."""
    return 6 * n_params * tokens + 6 * layers * heads * hd * seq * tokens


def phase_train(torch, K, T):
    """stablelm-1.6b at its full published size through
    ``repro_torch.launch.train.run_arch`` (AdamW, 8 microbatches of
    4,096 tokens, remat on) with every count set to 0 just before and read
    just after; then one step without remat, a profiled step, the step's
    gradients against every kernel swapped for its plain version, a
    checkpoint round trip and the smoke configs' step card vs CPU."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import steps as ST
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch import train as TR
    from repro_torch.models import model as M
    from repro_torch.models.runtime import Runtime
    from repro_torch.optim import make as make_opt

    cfg = TR.arch_config(TRAIN_ARCH, full=True)
    n_params = M.param_count(cfg)
    check(n_params == TRAIN_PARAMS, f"{n_params} parameters, expected "
                                    f"{TRAIN_PARAMS}")
    phase_memory(torch, f"train {cfg.name}")
    reset_counts(K, T)
    res = TR.run_arch(cfg, steps=TRAIN_STEPS, label="full", remat=True,
                      device="cuda", **TRAIN)
    counts = dict(flash=FA.flash_attention.launches,
                  lse=FA.flash_attention.lse_launches,
                  routes=dict(FA.flash_attention.route_launches),
                  flash_bwd=FA.flash_attention_bwd.launches,
                  bwd_routes=dict(FA.flash_attention_bwd.route_launches),
                  rmsnorm=RN.rmsnorm.launches,
                  rmsnorm_bwd=RN.rmsnorm_bwd.launches,
                  others=K.lstm_cell.launches + K.lstm_seq.launches +
                  K.lstm_seq_bwd.launches + T.ternary_encode.launches +
                  T.ternary_decode.launches + T.ef_compress_leaves.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = TRAIN_FLASH[True]
    bwd_step = TRAIN_FLASH_BWD_CALLS * FA.BWD_LAUNCHES
    want = dict(flash=per_step * TRAIN_STEPS, lse=per_step * TRAIN_STEPS,
                routes={"wgmma": per_step * TRAIN_STEPS, "wgmma_chunked": 0,
                        "tf32x3": 0, "cuda_core": 0, "hd_chunked": 0},
                flash_bwd=bwd_step * TRAIN_STEPS,
                bwd_routes={"wgmma": bwd_step * TRAIN_STEPS,
                            "wgmma_chunked": 0, "tf32x3": 0},
                rmsnorm=0, rmsnorm_bwd=0, others=0)
    print(f"[train] launches over {TRAIN_STEPS} steps {counts} (expected "
          f"{want}: {TRAIN_FLASH_BWD_CALLS} flash backward calls a step, "
          f"{FA.BWD_LAUNCHES} launches each); per step {res['launches']}")
    check(counts == want and all(
        s == {"flash_attention": per_step, "flash_lse": per_step,
              "flash_bwd": bwd_step, "rmsnorm": 0, "rmsnorm_bwd": 0}
        for s in res["launches"]),
          f"training launches {counts}, per step {res['launches']}, "
          f"expected {want}")
    check(all(math.isfinite(x) for x in res["losses"]),
          f"non-finite losses {res['losses']}")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    timed = res["step_s"][1:]
    step_s = statistics.mean(timed)
    mflops = model_flops(n_params, tokens, cfg.n_layers, cfg.n_heads,
                         cfg.hd, TRAIN["seq"])
    mfu = mflops / step_s / PEAK_BF16_FLOP_S
    print(f"[train] {cfg.name} full ({n_params:,} parameters, bf16), batch "
          f"{TRAIN['batch']} x {TRAIN['seq']} in {res['n_micro']} "
          f"microbatches, AdamW, remat: s per step "
          f"{', '.join(f'{t:.3f}' for t in res['step_s'])} (first: "
          f"warm-up); timed mean {step_s:.3f} s, {tokens / step_s:.0f} "
          f"tokens/s; model FLOPs {mflops / 1e12:.1f} T a step, "
          f"{mflops / step_s / 1e12:.1f} TFLOP/s = {100 * mfu:.1f}% of the "
          f"bf16 peak; peak memory {peak_gb:.2f} GB; losses "
          f"{[round(x, 4) for x in res['losses']]}")
    params = res["params"]
    del res
    torch.cuda.empty_cache()

    # one step without remat: one flash launch a layer a microbatch
    shape = InputShape("train", TRAIN["seq"], TRAIN["batch"], "train")
    opt = make_opt(TRAIN["optimizer"], TRAIN["lr"])
    batch = TR.sample_batch(np.random.RandomState(TRAIN["seed"]),
                            M.train_batch_spec(cfg, shape), cfg.vocab,
                            "cuda")
    bound = ST.bind_train(host_mesh(), cfg, Runtime(remat=False), opt,
                          shape, num_microbatches=TRAIN["micro"])
    before = (FA.flash_attention.launches, FA.flash_attention_bwd.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bound["grads"](params, batch)
    torch.cuda.synchronize()
    no_remat_s = time.perf_counter() - t0
    n = FA.flash_attention.launches - before[0]
    n_bwd = FA.flash_attention_bwd.launches - before[1]
    print(f"[train] without remat: {n} flash launches a step (expected "
          f"{TRAIN_FLASH[False]}), {n_bwd} flash backward launches "
          f"(expected {bwd_step}), the gradients in {no_remat_s:.3f} s")
    check(n == TRAIN_FLASH[False] and n_bwd == bwd_step,
          f"no-remat flash launches {n}, backward {n_bwd}")

    # one profiled step's gradients (remat on, the training path's)
    grads_fn = ST.bind_train(host_mesh(), cfg, Runtime(), opt, shape,
                             num_microbatches=TRAIN["micro"])["grads"]
    prof = train_profile(torch, lambda: grads_fn(params, batch),
                         prefill_fwd_kernels(cfg, 2 * TRAIN['micro']))
    grads_k, mets_k = prof.pop("out")

    # every kernel swapped for its plain version: the same step's gradients
    with plain_kernels():
        grads_p, mets_p = grads_fn(params, batch)
    loss_k, loss_p = float(mets_k["loss"]), float(mets_p["loss"])
    worst = max(rel_err(torch, a, b) for a, b in zip(tree.leaves(grads_k),
                                                     tree.leaves(grads_p)))
    del grads_k
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    params32 = tree.map(lambda t: t.float(), params)
    with plain_kernels():
        grads_32, mets_32 = ST.bind_train(
            host_mesh(), cfg32, Runtime(), opt, shape,
            num_microbatches=TRAIN["micro"])["grads"](params32, batch)
    noise = max(rel_err(torch, a, b) for a, b in zip(tree.leaves(grads_p),
                                                     tree.leaves(grads_32)))
    loss_32 = float(mets_32["loss"])
    del grads_p, grads_32, params32
    torch.cuda.empty_cache()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = worst <= TRAIN_GRAD_TOL and loss_rel <= TRAIN_LOSS_RTOL
    print(f"[train] kernel step vs plain step on the card: loss {loss_k:.6f}"
          f" vs {loss_p:.6f} (rel {loss_rel:.3e}, tol {TRAIN_LOSS_RTOL}); "
          f"worst gradient leaf max|diff| / max|g| {worst:.3e} (tol "
          f"{TRAIN_GRAD_TOL}); the bf16 plain step vs an fp32 plain step: "
          f"loss {loss_32:.6f}, worst leaf {noise:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the training step through the kernels disagrees with the "
              "plain step")
    del params, batch
    torch.cuda.empty_cache()
    smoke = phase_train_smoke(torch, TR, FA, RN)
    return dict(step_s=step_s, steps_s=timed, tokens_s=tokens / step_s,
                model_tflop_s=mflops / step_s / 1e12, mfu=mfu,
                peak_gb=peak_gb, counts=counts, no_remat_flash=n,
                no_remat_grads_s=no_remat_s, profile=prof,
                grad_err=worst, grad_noise=noise, loss_rel=loss_rel,
                smoke=smoke)


NEMOTRON_ARCH = "nemotron-4-340b"
# the published width (d_model 18,432, 96 query heads over 8 kv heads, hd
# 192, squared-ReLU d_ff 73,728, LayerNorm, partial RoPE, window 8,192)
# cut in depth, 96 -> 1 layer (96 layers hold ~680 GB of bf16 weights), and
# vocabulary, 256,000 -> 4,096 (the fp32 logits and unembedding of 256,000
# would take most of the card beside one layer's 7.2 GB of weights, its
# fp32 gradient accumulator and the update)
NEMOTRON_CUTS = dict(n_layers=1, vocab=4096)
NEMOTRON_PARAMS = 3_605_114_880
# 2 microbatches of 1 x 4,096 tokens a step, remat on, SGD (no optimizer
# state beside the weights); the first of NEMOTRON_STEPS is the warm-up
NEMOTRON_TRAIN = dict(batch=2, seq=4096, micro=2, lr=1e-3, optimizer="sgd",
                      seed=0)
NEMOTRON_STEPS = 2


def phase_train_nemotron(torch, K, T, smi):
    """One layer of nemotron-4-340b at its full width through
    ``launch/train.py::run_arch`` (``NEMOTRON_TRAIN``, every count set to 0
    just before and read just after): every flash backward launch on
    ``wgmma`` at hd 192, none on ``tf32x3``; then one profiled step's
    gradients (the device time under the flash backward's node), gated
    against the same step with ``ops.flash_attention_bwd`` patched to the
    plain backward: every gradient leaf within TRAIN_GRAD_TOL of its max
    |g|. Only that comparison tests the backward kernels; the loss (within
    TRAIN_LOSS_RTOL) comes from the same forward kernels on the same params
    and batch in both steps, so it agrees by construction and is a sanity
    check of the patch alone."""
    import dataclasses
    from unittest import mock
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import steps as ST
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch import train as TR
    from repro_torch.models import model as M
    from repro_torch.models.runtime import Runtime
    from repro_torch.optim import make as make_opt

    full = TR.arch_config(NEMOTRON_ARCH, full=True)
    cfg = dataclasses.replace(full, **NEMOTRON_CUTS)
    n_params = M.param_count(cfg)
    check(n_params == NEMOTRON_PARAMS and cfg.hd == 192,
          f"{n_params} parameters at hd {cfg.hd}, expected "
          f"{NEMOTRON_PARAMS} at hd 192")
    print(f"[nemotron] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads} (hd {cfg.hd}), {cfg.mlp} d_ff "
          f"{cfg.d_ff}, {cfg.norm}, window {cfg.sliding_window}; cut: "
          f"n_layers {full.n_layers} -> {cfg.n_layers}, vocab {full.vocab} "
          f"-> {cfg.vocab}; {n_params:,} parameters")
    tr = NEMOTRON_TRAIN
    phase_memory(torch, f"train {cfg.name} (1 layer)")
    reset_counts(K, T)
    res = TR.run_arch(cfg, steps=NEMOTRON_STEPS, label="1 layer, full width",
                      remat=True, device="cuda", **tr)
    counts = dict(flash=FA.flash_attention.launches,
                  fwd_routes=dict(FA.flash_attention.route_launches),
                  fwd_padded=FA.flash_attention.padded_launches,
                  flash_bwd=FA.flash_attention_bwd.launches,
                  bwd_routes=dict(FA.flash_attention_bwd.route_launches),
                  bwd_padded=FA.flash_attention_bwd.padded_launches,
                  rmsnorm=RN.rmsnorm.launches + RN.rmsnorm_bwd.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers, micro = cfg.n_layers, tr["micro"]
    bwd_step = layers * micro * FA.BWD_LAUNCHES
    fwd_step = 2 * layers * micro
    # every forward on wgmma at hd 192 (flash_kernel_wgmma_pipe)
    want = dict(flash=fwd_step * NEMOTRON_STEPS,
                fwd_routes=dict(dict.fromkeys(FA.flash_attention
                                              .route_launches, 0),
                                wgmma=fwd_step * NEMOTRON_STEPS),
                fwd_padded=0,
                flash_bwd=bwd_step * NEMOTRON_STEPS,
                bwd_routes={"wgmma": bwd_step * NEMOTRON_STEPS,
                            "wgmma_chunked": 0, "tf32x3": 0},
                bwd_padded=0, rmsnorm=0)
    print(f"[nemotron] launches over {NEMOTRON_STEPS} steps {counts} "
          f"(expected {want}); per step {res['launches']}")
    check(counts == want, f"nemotron launches {counts}, expected {want}")
    check(all(math.isfinite(x) for x in res["losses"]),
          f"non-finite losses {res['losses']}")
    tokens = tr["batch"] * tr["seq"]
    steps_s, losses = res["step_s"], res["losses"]
    step_s = steps_s[-1]
    mflops = model_flops(n_params, tokens, layers, cfg.n_heads, cfg.hd,
                         tr["seq"])
    params = res["params"]
    del res
    torch.cuda.empty_cache()

    shape = InputShape("train", tr["seq"], tr["batch"], "train")
    batch = TR.sample_batch(np.random.RandomState(tr["seed"]),
                            M.train_batch_spec(cfg, shape), cfg.vocab,
                            "cuda")
    grads_fn = ST.bind_train(host_mesh(), cfg, Runtime(),
                             make_opt(tr["optimizer"], tr["lr"]), shape,
                             num_microbatches=micro)["grads"]
    before = dict(FA.flash_attention_bwd.route_launches)
    before_fwd = dict(FA.flash_attention.route_launches)
    prof = train_profile(torch, lambda: grads_fn(params, batch),
                         prefill_fwd_kernels(cfg, 2 * micro))
    prof_bwd = {r: FA.flash_attention_bwd.route_launches[r] - before[r]
                for r in before}
    prof_fwd = {r: FA.flash_attention.route_launches[r] - before_fwd[r]
                for r in before_fwd}
    check(prof_bwd == {"wgmma": bwd_step, "wgmma_chunked": 0,
                       "tf32x3": 0},
          f"the profiled step's flash backward launches {prof_bwd}")
    check(prof_fwd["wgmma"] == fwd_step == sum(prof_fwd.values()) ==
          prof["flash_fwd_launches"],
          f"the profiled step's flash forward launches {prof_fwd}, "
          f"{prof['flash_fwd_launches']} flash_kernel* kernels")
    grads_k, mets_k = prof.pop("out")
    bwd_launch_ms = prof["flash_bwd_ms"] / sum(prof_bwd.values())
    fwd_launch_ms = prof["flash_fwd_ms"] / fwd_step
    with mock.patch.object(ops, "flash_attention_bwd",
                           ref.flash_attention_bwd):
        grads_p, mets_p = grads_fn(params, batch)
    loss_k, loss_p = float(mets_k["loss"]), float(mets_p["loss"])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    errs = [rel_err(torch, a, b) for a, b in zip(tree.leaves(grads_k),
                                                 tree.leaves(grads_p))]
    ok = max(errs) <= TRAIN_GRAD_TOL and loss_rel <= TRAIN_LOSS_RTOL
    print(f"[nemotron] kernel backward vs the plain backward, the same step: "
          f"loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}, tol "
          f"{TRAIN_LOSS_RTOL}); worst of {len(errs)} gradient leaves "
          f"max|diff| / max|g| {max(errs):.3e} (tol {TRAIN_GRAD_TOL}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the nemotron step through the backward kernels disagrees "
              "with the plain backward's")
    del grads_k, grads_p, params, batch
    torch.cuda.empty_cache()
    print(f"[nemotron] {smi}: {cfg.name} 1 layer full width, {tokens} "
          f"tokens a step in {micro} microbatches, SGD, remat: s per step "
          f"{', '.join(f'{t:.3f}' for t in steps_s)} (first: warm-up; "
          f"losses {[round(x, 4) for x in losses]}); {tokens / step_s:.0f} "
          f"tokens/s, "
          f"{mflops / step_s / 1e12:.1f} TFLOP/s of model FLOPs; peak memory "
          f"{peak_gb:.2f} GB; the flash backward's node "
          f"{prof['flash_bwd_ms']:.3f} ms of device time over "
          f"{sum(prof_bwd.values())} launches, {bwd_launch_ms:.4f} ms a "
          f"launch; the flash forward (flash_kernel_wgmma_pipe) "
          f"{prof['flash_fwd_ms']:.3f} ms over {fwd_step} launches, "
          f"{fwd_launch_ms:.4f} ms a launch")
    return dict(step_s=step_s, steps_s=steps_s, tokens_s=tokens / step_s,
                model_tflop_s=mflops / step_s / 1e12, peak_gb=peak_gb,
                counts=counts,
                launches_per_step=counts["flash_bwd"] // NEMOTRON_STEPS,
                profile=prof, bwd_device_ms_per_launch=bwd_launch_ms,
                fwd_device_ms_per_launch=fwd_launch_ms,
                grad_err=max(errs), loss_rel=loss_rel, n_params=n_params,
                cuts=NEMOTRON_CUTS)


def phase_train_smoke(torch, TR, FA, RN):
    """The smoke configs (fp32) on the card: a ``--ckpt`` run through
    ``run_arch`` whose saved state loads back bit for bit; each config's
    step gradients on the card against the CPU (dense, moe, ssm and
    hybrid; with experts the CPU step replays the card's expert choices);
    the RMSNorm forward and backward and flash launches exact."""
    import contextlib
    import tempfile
    from repro_torch import tree
    out = {}
    with tempfile.TemporaryDirectory() as d:
        res = TR.run_arch(TR.arch_config(TRAIN_ARCH), steps=2, ckpt=d,
                          ckpt_every=2, device="cuda", **TRAIN_SMOKE)
        saved, meta = res["store"].load(res["store"].latest())
        same = all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(
            tree.leaves({"params": res["params"], "opt": res["opt_state"]}),
            tree.leaves(tree.to_device(saved, "cuda")), strict=True))
        print(f"[train] checkpoint of the smoke run on the card "
              f"({len(tree.leaves(saved))} leaves, meta {meta}): loaded "
              f"state bit-equal {same}")
        check(same and meta == {"step": 2}, "checkpoint round trip differs")
    for arch in (TRAIN_ARCH, SERVE_ARCH, *MOE_SMOKE_ARCHS, SSM_ARCH,
                 HYBRID_ARCH):
        cfg = TR.arch_config(arch)
        runs = {}
        book = RouteBook()
        for dev in ("cuda", "cpu"):
            run = TR.setup_arch(cfg, device=dev, **TRAIN_SMOKE)
            if dev == "cuda":
                params0 = run["params"]
            batch = TR.sample_batch(run["rng"], run["bound"]["batch_shape"],
                                    cfg.vocab, dev)
            before = (FA.flash_attention.launches,
                      FA.flash_attention.route_launches["tf32x3"],
                      RN.rmsnorm.launches,
                      FA.flash_attention_bwd.route_launches["tf32x3"],
                      FA.flash_attention_bwd.launches,
                      RN.rmsnorm_bwd.launches)
            routes = contextlib.nullcontext()
            if cfg.moe.num_experts:
                routes = recorded_routes(book) if dev == "cuda" else \
                    replayed_routes(book)
            with routes:
                g, m = run["bound"]["grads"](tree.to_device(params0, dev),
                                             batch)
            runs[dev] = (tree.to_device(g, "cpu"), float(m["loss"]),
                         (FA.flash_attention.launches - before[0],
                          FA.flash_attention.route_launches["tf32x3"] -
                          before[1],
                          RN.rmsnorm.launches - before[2],
                          FA.flash_attention_bwd.route_launches["tf32x3"] -
                          before[3],
                          FA.flash_attention_bwd.launches - before[4],
                          RN.rmsnorm_bwd.launches - before[5]))
        worst = max(rel_err(torch, a, b) for a, b in zip(
            tree.leaves(runs["cuda"][0]), tree.leaves(runs["cpu"][0])))
        loss_rel = abs(runs["cuda"][1] - runs["cpu"][1]) / runs["cpu"][1]
        # per microbatch: the attention layers' flash (x2 under remat), all
        # fp32 on the tf32x3 route; the norms (``layer_norms``: 2 a layer,
        # 1 in the ssm family), again under remat, and the final one; the
        # flash backward once an attention layer, fp32 on the tf32x3 route,
        # all of its launches; the norms' backward once each, two launches
        # a call
        La, n, norms = attention_layers(cfg), TRAIN_SMOKE["micro"], \
            layer_norms(cfg)
        bwd = La * n * FA.BWD_LAUNCHES
        rms = cfg.norm == "rmsnorm"
        want = (2 * La * n, 2 * La * n, (2 * norms + 1) * n if rms else 0,
                bwd, bwd, (norms + 1) * n * RN.BWD_LAUNCHES if rms else 0)
        ok = worst <= TRAIN_SMOKE_TOL and loss_rel <= TRAIN_SMOKE_TOL
        replay = (f"; the CPU replayed the card's expert choices ({book.calls}"
                  f" router calls; on its own {book.flips} pairs otherwise)"
                  if cfg.moe.num_experts else "")
        print(f"[train] {arch} smoke fp32 step, card vs CPU: loss rel "
              f"{loss_rel:.3e}, worst gradient leaf {worst:.3e} (tol "
              f"{TRAIN_SMOKE_TOL}) {'ok' if ok else 'FAIL'}; card launches "
              f"flash/flash on the tf32x3 route/rmsnorm/flash backward on "
              f"the tf32x3 route/flash backward/rmsnorm backward "
              f"{runs['cuda'][2]} (expected {want}){replay}")
        check(ok, f"{arch}: the smoke step differs card vs CPU")
        check(runs["cuda"][2] == want and runs["cpu"][2] == (0,) * 6,
              f"{arch}: smoke launches {runs['cuda'][2]}, expected {want}")
        out[arch] = dict(grad_err=worst, loss_rel=loss_rel)
    return out


# ---------------------------------------------------------------------------
# the RMSNorm backward kernel, and the moe family: deepseek-moe-16b served at
# its published size and trained at 2 layers, the smoke configs card vs CPU
# ---------------------------------------------------------------------------

# the backward at the training path's rows, bf16: qwen1.5-110b's width and
# deepseek-moe-16b's (a microbatch of 4,096 tokens)
# the training rows of the RMSNorm backward: qwen's width, deepseek-moe-
# 16b's, internvl2-1b's (896, 112 16-byte pieces a row) and falcon-mamba-
# 7b's and jamba's (4,096, a microbatch of their training steps)
RMS_BWD_SHAPES = ((4096, 8192), (4096, 2048), (4096, 896), (4096, 4096))
MOE_ARCH = "deepseek-moe-16b"
MOE_SMOKE_ARCHS = ("deepseek-moe-16b", "arctic-480b")
# no reduction: the published model, bf16, fits one card (33.76 GB)
MOE_PARAMS = 16_879_568_896
# the training leg's one reduction: depth 28 -> 2 layers at full width and
# vocabulary (all and active parameters); stablelm's traffic (TRAIN)
MOE_TRAIN_CUTS = dict(n_layers=2)
MOE_TRAIN_PARAMS = (1_595_156_480, 591_669_248)
MOE_TRAIN_STEPS = 3
# layers whose post-norm input the sort path is held on against the dense
# oracle: first, middle, last
MOE_ORACLE_LAYERS = (0, 13, 27)
# sort vs dense at a capacity where nothing drops: the same bf16 products,
# the combine summed in another order and rounding (2e-2 of max |out|, bf16
# at tests/test_kernels.py::_tol); the router loss from the same fp32 probs
# and choices
MOE_ORACLE_TOL, MOE_AUX_RTOL = 2e-2, 1e-5
# kernels of a profiled moe prefill or decode step by kind, first match wins
MOE_KERNEL_KINDS = (
    ("flash_attention", r"flash_kernel"),
    ("rmsnorm", r"rmsnorm"),
    ("sort (route, dispatch order)", r"[Ss]ort|[Rr]adix"),
    ("index, scatter, gather (dispatch, combine)",
     r"[Ii]ndex|[Ss]catter|[Gg]ather"),
    ("fp32 GEMMs (router, logits)", r"f32f32_f32f32|sgemm"),
    ("bf16 GEMMs (projections, expert bmm, shared experts)",
     r"bf16|nvjet|gemm"),
    ("NaN fills (deterministic mode)", r"[Ff]ill"),
    ("other", r""))


def rms_bwd_bound_ms(rows, d, elem_bytes):
    """x, dy and scale read once, dx and dscale written once; ~12 flops an
    element at the fp32 rate."""
    moved = elem_bytes * (3 * rows * d + 2 * d)
    t_b, t_o = moved / PEAK_BYTES_S, 12 * rows * d / PEAK_FP32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def rms_bwd_host_steps(torch, RN, x, s, dy):
    """Host microseconds of each step of one ``rmsnorm_bwd`` call at x's
    shape, each step alone in a loop, beside the whole call and the
    yardstick's whole call (two ctypes calls and three allocations): the
    wrapper's cost is host time when the device works ~10 us."""
    from repro_torch.kernels import build as kbuild
    fn = RN.build_bwd()[x.dtype]
    dx, ds = RN.rmsnorm_bwd(x, s, dy)
    rows, D = x.shape
    dev = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ptrs = (x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr())
    n_part = RN.BWD_PART_ROWS * D
    part = RN._part(dev, stream, n_part).data_ptr()
    steps = {
        "whole call": lambda: RN.rmsnorm_bwd(x, s, dy),
        "yardstick's whole call": lambda: RN.rmsnorm_bwd_yardstick(x, s, dy),
        "checks": lambda: RN._check_bwd(x, s, dy),
        "bind": lambda: RN.build_bwd()[x.dtype],
        "outputs (no fill)": lambda: kbuild.empty_likes(x, s),
        "pointers and alignment": lambda: (
            x.data_ptr() | s.data_ptr() | dy.data_ptr() | dx.data_ptr()) % 16,
        "current device test": lambda: dev == torch.cuda.current_device(),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev),
        "partials' buffer": lambda: RN._part(dev, stream, n_part),
        "C call and its two launches": lambda: fn(
            *ptrs, ds.data_ptr(), part, rows, D, 1e-6, 1, stream),
    }
    before = RN.rmsnorm_bwd.launches
    us = {}
    for name, step in steps.items():
        for _ in range(100):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            step()
        us[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    RN.rmsnorm_bwd.launches = before      # timing calls are not the path's
    print(f"[host] rmsnorm_bwd wrapper steps at {list(x.shape)} "
          f"{str(x.dtype).split('.')[-1]}, us a call: " +
          ", ".join(f"{k} {v:.3f}" for k, v in us.items()))
    return us


# the training rows where the kernel must beat its yardstick (elsewhere it
# must be no slower): internvl2-1b's, where host time dominates both
RMS_BWD_FASTER_AT = (4096, 896)


def rms_bwd_gate(shape, turns, dev, yard_dev) -> bool:
    """The ``rmsnorm_bwd`` timing gate at one training shape: by the
    medians of the device windows (``dev``, ``yard_dev``) no slower than
    the yardstick, and at ``RMS_BWD_FASTER_AT`` faster, there also by the
    median of the wrapper-timed event turns (``turns``: each side's list)
    against the yardstick's median. A median against a median: one fast
    yardstick turn, host noise, cannot decide it."""
    if dev is None or yard_dev is None:
        return False
    if tuple(shape) != RMS_BWD_FASTER_AT:
        return dev <= yard_dev
    return dev < yard_dev and statistics.median(turns["kernel"]) < \
        statistics.median(turns["yardstick"])


def phase_rmsnorm_bwd(torch, RN, ref):
    """The RMSNorm backward (one C call of two launches: the rows kernel of
    the row's tier, dx and the blocks' column partials, then the cols
    kernel, dscale) and its yardstick (``RN.rmsnorm_bwd_yardstick``,
    the first kernels) against ``ref.rmsnorm_bwd`` over the JAX sweep
    (fp32, bf16) and the training rows ``RMS_BWD_SHAPES`` (bf16): dx and
    dscale within TOL of max |grad|, two runs bit-equal, exact launches;
    a non-contiguous dy on the card refused before any launch; timed at
    the training rows in turns with the yardstick (CUDA events over
    back-to-back wrapper calls) and by the device time a call (profiled
    windows in turns, each window's launch count held), beside the plain
    backward, ``F.rms_norm``'s forward + backward and its backward alone
    (events), the bound and the device time's share of it (the aim: at
    least half); the wrapper's host time step by step at internvl2-1b's
    rows. ``rms_bwd_gate`` decides each shape: by the medians of the
    device windows the kernel must be faster than the yardstick at
    ``[4096, 896]`` and no slower at the other rows; at ``[4096, 896]``
    its event median must also be below the yardstick's."""
    import torch.nn.functional as F
    cases = [(shape, dt) for shape in RMS_SWEEP
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(shape, torch.bfloat16) for shape in RMS_BWD_SHAPES]
    worst_abs, worst_rel = 0.0, 0.0
    for i, (shape, dtype) in enumerate(cases):
        name = str(dtype).split(".")[-1]
        x = randn(torch, shape, dtype, 300 + i)
        s = randn(torch, shape[-1:], dtype, 400 + i, 0.1) + 1
        dy = randn(torch, shape, dtype, 500 + i)
        before = RN.rmsnorm_bwd.launches
        got = RN.rmsnorm_bwd(x, s, dy)
        again = RN.rmsnorm_bwd(x, s, dy)
        launched = RN.rmsnorm_bwd.launches - before
        yard = RN.rmsnorm_bwd_yardstick(x, s, dy)
        want = ref.rmsnorm_bwd(x, s, dy)
        torch.cuda.synchronize()
        rel = [rel_err(torch, g, w) for g, w in zip(got, want)]
        yrel = [rel_err(torch, g, w) for g, w in zip(yard, want)]
        absd = max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = max(rel) <= TOL[name] and max(yrel) <= TOL[name] and same and \
            launched == 2 * RN.BWD_LAUNCHES and \
            got[0].dtype == got[1].dtype == dtype
        print(f"[kernel] rmsnorm_bwd {list(shape)} {name}: dx "
              f"{rel[0]:.3e}, dscale {rel[1]:.3e} of max |grad| (yardstick "
              f"{yrel[0]:.3e}, {yrel[1]:.3e}; tol {TOL[name]}), "
              f"max|kernel-plain| {absd:.3e}, two runs bit-equal {same}, "
              f"{launched} launches {'ok' if ok else 'FAIL'}")
        check(ok, f"rmsnorm_bwd {shape} {name}: the kernel or its yardstick "
                  f"disagrees with the plain version, differs run to run or "
                  f"did not launch")
        worst_abs, worst_rel = max(worst_abs, absd), max(worst_rel, *rel)
    # the checks refuse a strided dy on the card too, before any launch
    x = randn(torch, (64, 128), torch.bfloat16, 1)
    before = RN.rmsnorm_bwd.launches
    try:
        RN.rmsnorm_bwd(x, x[0].contiguous(), x.t().contiguous().t())
        check(False, "rmsnorm_bwd took a strided dy")
    except ValueError as e:
        print(f"[kernel] rmsnorm_bwd refuses a strided dy on the card: {e}")
    check(RN.rmsnorm_bwd.launches == before, "a refused call launched")
    times = {}
    for rows, d in RMS_BWD_SHAPES:
        x = randn(torch, (rows, d), torch.bfloat16, 7)
        s = randn(torch, (d,), torch.bfloat16, 8, 0.1) + 1
        dy = randn(torch, (rows, d), torch.bfloat16, 9)
        turns = in_turns(torch, lambda: RN.rmsnorm_bwd(x, s, dy),
                         lambda: RN.rmsnorm_bwd_yardstick(x, s, dy),
                         reps=20, inner=10)
        ms = statistics.median(turns["kernel"])
        yard_ms = statistics.median(turns["yardstick"])
        dev_turns, dev_names, yard_names = device_in_turns(
            torch, lambda: RN.rmsnorm_bwd(x, s, dy),
            lambda: RN.rmsnorm_bwd_yardstick(x, s, dy), RN.BWD_LAUNCHES)
        dev, yard_dev = (statistics.median(dev_turns[who])
                         if dev_turns[who] else None
                         for who in ("kernel", "yardstick"))
        plain_ms = median_ms(lambda: ref.rmsnorm_bwd(x, s, dy), torch,
                             reps=10, inner=3)
        lib = (x.detach().clone().requires_grad_(),
               s.detach().clone().requires_grad_())

        def lib_fb():
            y = F.rms_norm(lib[0], (d,), lib[1], 1e-6)
            torch.autograd.grad(y, lib, dy)

        y_lib = F.rms_norm(lib[0], (d,), lib[1], 1e-6)

        def lib_bwd():
            torch.autograd.grad(y_lib, lib, dy, retain_graph=True)

        fb_ms = median_ms(lib_fb, torch, reps=20, inner=5)
        lib_ms = median_ms(lib_bwd, torch, reps=20, inner=5)
        del y_lib
        bound, by = rms_bwd_bound_ms(rows, d, 2)
        share = None if dev is None else bound / dev
        print(f"[kernel] rmsnorm_bwd time [{rows}, {d}] bf16, in turns: "
              f"kernel {fmt_turns(turns['kernel'])} ms (median {ms:.5f}), "
              f"yardstick {fmt_turns(turns['yardstick'])} ms (median "
              f"{yard_ms:.5f}); device time a call in turns: kernel "
              f"{fmt_turns(dev_turns['kernel'])} ms (median {fmt_ms(dev)}) "
              f"{dev_names}, yardstick {fmt_turns(dev_turns['yardstick'])} "
              f"ms (median {fmt_ms(yard_dev)}) {yard_names}; bound "
              f"{bound:.5f} ms ({by}; "
              f"{'not measured' if share is None else f'{100 * share:.1f}%'}"
              f" of it by device time, at least half: "
              f"{'not measured' if share is None else share >= 0.5}), plain "
              f"{plain_ms:.4f} ms, F.rms_norm forward + backward "
              f"{fb_ms:.4f} ms, its backward alone {lib_ms:.4f} ms")
        check(dev is not None and yard_dev is not None,
              f"rmsnorm_bwd at [{rows}, {d}]: no device window held its "
              f"launch count: {dev_turns}")
        check(rms_bwd_gate((rows, d), turns, dev, yard_dev),
              f"rmsnorm_bwd at [{rows}, {d}] is slower than its yardstick "
              f"(faster wanted at {list(RMS_BWD_FASTER_AT)}): {turns}, "
              f"device {dev_turns}")
        times[f"{rows}x{d}"] = dict(
            shape=[rows, d], ms=ms, turns=turns, yardstick_ms=yard_ms,
            device_ms=dev, device_turns=dev_turns, kernel_ms=dev_names,
            yardstick_device_ms=yard_dev,
            yardstick_kernel_ms=yard_names, bound_share=share,
            plain_ms=plain_ms, library_ms=lib_ms,
            lib_fwd_bwd_ms=fb_ms, bound_ms=bound, bound_by=by)
    x = randn(torch, (4096, 896), torch.bfloat16, 7)
    host = rms_bwd_host_steps(torch, RN, x, randn(
        torch, (896,), torch.bfloat16, 8, 0.1) + 1, randn(
        torch, (4096, 896), torch.bfloat16, 9))
    return dict(max_abs_err=worst_abs, max_rel_err=worst_rel,
                host_us=host, **times)


def weight_bytes(params):
    from repro_torch import tree
    return sum(t.numel() * t.element_size() for t in tree.leaves(params))


def flash_held(torch, FA, ref, shape, tag):
    """The flash forward at one of a model's shapes, bf16 on ``wgmma``,
    with and without lse: out against the plain version at the qwen gate
    with inputs x0.5 and x2, lse within TRAIN_LSE_TOL (a zero-filled row
    past the end left in the softmax would move it), out with and without
    lse bit-equal; timed beside the plain version, SDPA and the bound."""
    B, S, H, Kv, hd, causal = shape
    check(FA.route(torch.bfloat16, hd, S, H // Kv) == "wgmma",
          f"{tag}: does not route to wgmma")
    mask = "causal" if causal else "non-causal"
    name = f"flash_attention {tag} B={B} S={S} H={H} Kv={Kv} (G = " \
           f"{H // Kv}) hd={hd} {mask} bf16"
    err = 0.0
    for j, scale in enumerate(QWEN_FLASH_SCALES):
        q, k, v = (randn(torch, (B, S, n, hd), torch.bfloat16, 80 + 3 * j + i,
                         scale) for i, n in enumerate((H, Kv, Kv)))
        before = FA.flash_attention.route_launches["wgmma"]
        o, lse = FA.flash_attention(q, k, v, causal=causal, with_lse=True)
        po, plse = ref.flash_attention(q, k, v, causal=causal, with_lse=True)
        check(torch.equal(o, FA.flash_attention(q, k, v, causal=causal)),
              f"{name}: out differs with and without lse")
        check(FA.flash_attention.route_launches["wgmma"] - before == 2,
              f"{name}: not two wgmma launches")
        err = max(err, held(torch, f"{name} x{scale}", o, po,
                            TOL["bfloat16"], QWEN_FLASH_BF16_ATOL))
        rtol, atol = TRAIN_LSE_TOL
        lse_err = (lse - plse).abs().max().item()
        ok = bool(((lse - plse).abs() <= rtol * plse.abs() + atol).all())
        print(f"[kernel] {name} x{scale}: lse max|kernel-plain| "
              f"{lse_err:.3e} (rtol {rtol} atol {atol}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: the kernel's lse disagrees with the plain lse")
    ms = median_ms(lambda: FA.flash_attention(q, k, v, causal=causal), torch,
                   reps=10, inner=5)
    ms_lse = median_ms(lambda: FA.flash_attention(q, k, v, causal=causal,
                                                  with_lse=True),
                       torch, reps=10, inner=5)
    plain_ms = median_ms(lambda: ref.flash_attention(q, k, v, causal=causal),
                         torch, reps=5, inner=2)
    torch.use_deterministic_algorithms(False)
    try:
        lib = sdpa(torch, q, k, v, causal)
        backend = sdpa_backend(torch, lib)
        lib_ms = median_ms(lib, torch, reps=10, inner=5)
    finally:
        torch.use_deterministic_algorithms(True)
    bound, by = flash_bound_ms(B, S, H, Kv, hd, 2, causal=causal)
    print(f"[kernel] {name} time: kernel {ms:.4f} ms (with lse "
          f"{ms_lse:.4f}), plain {plain_ms:.4f} ms, SDPA ({backend}) "
          f"{lib_ms:.4f} ms, bound {bound:.5f} ms ({by}); "
          f"{ms / bound:.2f}x the bound, {ms / lib_ms:.2f}x SDPA")
    return dict(shape=list(shape), max_abs_err=err, lse_err=lse_err, ms=ms,
                lse_ms=ms_lse, plain_ms=plain_ms, library_ms=lib_ms,
                library_backend=backend, bound_ms=bound, bound_by=by)


def moe_oracle(torch, M, params, cfg, prompt_toks):
    """The post-norm inputs of layers ``MOE_ORACLE_LAYERS`` in a full-size
    prefill, each through ``apply_moe_sort`` at a capacity where nothing
    drops (cf = E / k; C at least the largest expert load, printed) against
    ``apply_moe_dense``: out within MOE_ORACLE_TOL of max |out|, the router
    loss within MOE_AUX_RTOL."""
    from unittest import mock
    from repro_torch.models import moe
    from repro_torch.models.runtime import DEFAULT
    seen = []
    real = moe.apply_moe

    def capture(p, x, cfg_, rt, **kw):
        seen.append((p, x) if len(seen) in MOE_ORACLE_LAYERS else None)
        return real(p, x, cfg_, rt, **kw)

    with torch.no_grad(), mock.patch.object(moe, "apply_moe", capture):
        cache = M.init_cache(cfg, prompt_toks.shape[0],
                             prompt_toks.shape[1] + 8, device="cuda")
        M.prefill(params, cfg, DEFAULT, {"tokens": prompt_toks}, cache)
        del cache
    check(len(seen) == cfg.n_layers, f"{len(seen)} moe calls in a prefill")
    m = cfg.moe
    cf = m.num_experts / m.top_k
    out = {}
    with torch.no_grad():
        for layer in MOE_ORACLE_LAYERS:
            p, x = seen[layer]
            xt = x.reshape(-1, x.shape[-1])
            T = xt.shape[0]
            book = RouteBook()
            book.idx.append(moe.route(moe.router_probs(p, xt), m.top_k)[1])
            _, C, _, load = route_drops(torch, book, cfg, cf)[0]
            o_s, a_s = moe.apply_moe_sort(p, xt, cfg, cf)
            o_d, a_d = moe.apply_moe_dense(p, xt, cfg)
            err = rel_err(torch, o_s, o_d)
            a_rel = abs(float(a_s) - float(a_d)) / abs(float(a_d))
            ok = C >= load and err <= MOE_ORACLE_TOL and a_rel <= MOE_AUX_RTOL
            print(f"[moe] layer {layer}: sort dispatch at cf {cf:.4f} (C = "
                  f"{C} for {T} tokens, largest expert load {load}) vs the "
                  f"dense oracle: out max|diff| / max|out| {err:.3e} (tol "
                  f"{MOE_ORACLE_TOL}), router loss rel {a_rel:.3e} (tol "
                  f"{MOE_AUX_RTOL}) {'ok' if ok else 'FAIL'}")
            check(ok, f"layer {layer}: the sort dispatch disagrees with the "
                      f"dense oracle where nothing drops")
            out[layer] = dict(C=C, max_load=load, out_err=err, aux_rel=a_rel)
            del o_s, o_d
    return out


def moe_profile(torch, M, params, cfg, prompt_toks):
    """One prefill and one decode step of the full-size moe model under
    ``torch.profiler``: window, busy share, kernels, device ms by kind
    (``MOE_KERNEL_KINDS``), the top kernels; the prefill's flash forward
    kernels held to ``prefill_fwd_kernels``, the decode step's to none."""
    from repro_torch.launch.serve import greedy
    from repro_torch.models.runtime import DEFAULT
    B, P = prompt_toks.shape
    state = {}

    def pre():
        cache = M.init_cache(cfg, B, P + SERVE["tokens"] + 8, device="cuda")
        logits, state["cache"] = M.prefill(params, cfg, DEFAULT,
                                           {"tokens": prompt_toks}, cache)
        state["tok"] = greedy(logits)

    def dec():
        M.decode_step(params, cfg, DEFAULT, state["tok"], state["cache"], P)

    out = {}
    with torch.no_grad():
        pre()
        dec()
        for key, fn in (("prefill", pre), ("decode", dec)):
            window_ms, busy_ms, n_kernels, by_name, _ = profiled(torch, fn)
            kinds = dict.fromkeys((k for k, _ in MOE_KERNEL_KINDS), 0.0)
            for name, (_, t) in by_name.items():
                kinds[next(k for k, pat in MOE_KERNEL_KINDS
                           if re.search(pat, name))] += t
            print(f"[profile] {cfg.name} one {key} (B={B}, {P} prompt "
                  f"tokens): window {window_ms:.2f} ms, device busy "
                  f"{busy_ms:.2f} ms ({100 * busy_ms / window_ms:.1f}%), "
                  f"{n_kernels} kernels; by kind: " +
                  ", ".join(f"{k} {t:.3f} ms" for k, t in kinds.items()))
            for name, (n, t) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1])[:8]:
                print(f"[profile]   {t:.3f} ms in {n} x {name[:90]}")
            out[key] = dict(window_ms=window_ms, busy_ms=busy_ms,
                            kernels=n_kernels, kinds=kinds,
                            rmsnorm_ms=per_launch_ms(by_name, "rmsnorm_"),
                            flash_ms=per_launch_ms(by_name, "flash_kernel"),
                            fwd_kernels=check_fwd_kernels(
                                f"{cfg.name} one {key}", by_name,
                                prefill_fwd_kernels(cfg) if key == "prefill"
                                else {}))
    return out


def phase_serve_moe(torch, K, T, smi):
    """deepseek-moe-16b at its published size (no reduction) served through
    ``launch/serve.py::serve`` with every count set to 0 just before and
    read just after: 28 flash launches a prefill, all on ``wgmma``; 57
    rmsnorm launches a prefill and a decode step; no backward launch. Then,
    on the same weights: the sort dispatch against the dense oracle on
    three layers' inputs, the kernel path against the plain path
    teacher-forced with the expert choices replayed (and the dropped
    assignments at the default capacity), a profiled prefill and decode
    step, and the flash forward timed at its attention shape."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models import model as M

    cfg = C.get(MOE_ARCH)
    n_params = M.param_count(cfg)
    n_active = M.param_count(cfg, active_only=True)
    check(n_params == MOE_PARAMS, f"{n_params} parameters, expected "
                                  f"{MOE_PARAMS}")
    base_gb = phase_memory(torch, f"serve {cfg.name}")
    reset_counts(K, T)
    t0 = time.perf_counter()
    res = serve(cfg, device="cuda", **SERVE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = serve_counts(K, T)
    routes = dict(FA.flash_attention.route_launches)
    lse_launches = FA.flash_attention.lse_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_batches = -(-SERVE["requests"] // SERVE["batch"])
    L = cfg.n_layers
    want = dict(rmsnorm=(2 * L + 1) * SERVE["tokens"] * n_batches,
                flash_attention=L * n_batches, rmsnorm_bwd=0, others=0)
    prefill_ms = [t * 1e3 for t in res["prefill_s"]]
    decode_ms = [t / (SERVE["tokens"] - 1) * 1e3 for t in res["decode_s"]]
    tok_s = SERVE["requests"] * SERVE["tokens"] / (sum(res["prefill_s"]) +
                                                  sum(res["decode_s"]))
    toks = res["tokens"]
    print(f"[moe] {cfg.name} published size ({n_params:,} parameters, "
          f"{n_active:,} active a token; {L} layers, d_model {cfg.d_model}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.num_shared} shared, bf16, sort dispatch at capacity "
          f"factor {cfg.moe.capacity_factor}), requests={SERVE['requests']} "
          f"batch={SERVE['batch']} prompt={SERVE['prompt']} tokens="
          f"{SERVE['tokens']}: prefill ms per batch "
          f"{', '.join(f'{t:.2f}' for t in prefill_ms)}; decode ms per "
          f"token step {', '.join(f'{t:.3f}' for t in decode_ms)}; "
          f"{tok_s:.1f} tok/s over the run (wall {wall_s:.1f} s with the "
          f"weights' init); peak memory {peak_gb:.2f} GB ({base_gb:.2f} GB "
          f"allocated before the phase); launches {counts} (expected "
          f"{want}), flash_attention by route {routes}")
    check(counts == want and res["launches"] == {
        k: v for k, v in want.items() if k != "others"},
        f"moe serve launches {counts} / {res['launches']}, expected {want}")
    check(routes == dict(dict.fromkeys(routes, 0),
                         wgmma=want["flash_attention"]),
          f"moe serve flash routes {routes}: every launch should run wgmma")
    check(lse_launches == 0, f"{lse_launches} serve launches wrote lse")
    check(tuple(toks.shape) == (SERVE["requests"], SERVE["tokens"]) and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"served tokens {tuple(toks.shape)} out of shape or range")

    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SERVE["seed"]), "cuda")
    w_bytes = weight_bytes(params)
    decode_bound_ms = w_bytes / PEAK_BYTES_S * 1e3
    print(f"[moe] {smi}: decode {min(decode_ms):.3f} ms a step at best "
          f"against its bound {decode_bound_ms:.3f} ms (every step reads "
          f"all {w_bytes / 1e9:.2f} GB of weights: the sort dispatch runs "
          f"all {cfg.moe.num_experts} experts' products at C = 1; "
          f"{w_bytes / 1e9 / (min(decode_ms) / 1e3) / 1e3:.2f} TB/s "
          f"achieved)")
    prompts = make_prompts(cfg, SERVE["requests"], SERVE["prompt"],
                           SERVE["seed"])
    batch0 = torch.from_numpy(np.stack(prompts[:SERVE["batch"]])).cuda()
    oracle = moe_oracle(torch, M, params, cfg, batch0)

    worst, drops, alone = 0.0, None, {}
    book = RouteBook()
    for b0 in range(0, SERVE["requests"], SERVE["batch"]):
        p = torch.from_numpy(np.stack(prompts[b0:b0 + SERVE["batch"]])).cuda()
        g = toks[b0:b0 + SERVE["batch"]].cuda()
        err, same, _ = hold_logits(torch, M, params, cfg, p, g,
                                f"{cfg.name} requests {b0}-"
                                f"{b0 + SERVE['batch'] - 1}", book=book)
        check(same, "the kernel path gave other tokens on a second run")
        worst = max(worst, err)
        alone = {k: max(v, alone.get(k, 0.0)) for k, v in book.alone.items()}
        if drops is None:
            drops = served_drops(torch, book, cfg, "[moe]")
    prof = moe_profile(torch, M, params, cfg, batch0)
    del params
    torch.cuda.empty_cache()
    attn = flash_held(torch, FA, ref, served_flash_shape(cfg, SERVE),
                      f"{cfg.name} prefill")
    return dict(n_params=n_params, n_active=n_active, counts=counts,
                routes=routes, prefill_ms=prefill_ms, decode_ms=decode_ms,
                decode_bound_ms=decode_bound_ms, tok_s=tok_s,
                peak_gb=peak_gb, base_gb=base_gb, logit_err=worst,
                logit_err_alone=alone, drops=drops,
                oracle=oracle, profile=prof, attention=attn)


# ---------------------------------------------------------------------------
# the ssm and hybrid families: falcon-mamba-7b served whole, jamba-v0.1-52b
# served at two of its four 8-layer periods
# ---------------------------------------------------------------------------

SSM_ARCH = "falcon-mamba-7b"
# no reduction: the published model, bf16, fits one card (14.55 GB)
SSM_PARAMS = 7_272_665_088
HYBRID_ARCH = "jamba-v0.1-52b"
# one reduction: depth 32 -> 16 layers (two of the four 8-layer periods, so
# the stacking over units runs) at full width and vocabulary, 52.1 GB of
# bf16 weights; three periods (77.6 GB) leave no room for a moe sublayer's
# draw and a prefill on an 80 GB card. (all, active) parameters
HYBRID_CUTS = dict(n_layers=16)
HYBRID_PARAMS = (26_053_595_136, 6_323_589_120)
# the fp32 hold's cut: one period (8 layers, 12.76 B parameters, 51.0 GB in
# fp32; two periods would be 104 GB)
HYBRID_FP32_CUTS = dict(n_layers=8)
# kernels of a profiled ssm or hybrid prefill or decode step by kind, first
# match wins; the selective scan's own share is read from its spans
FAMILY_KERNEL_KINDS = (
    ("flash_attention", r"flash_kernel"),
    ("rmsnorm", r"rmsnorm"),
    ("sort, index, scatter, gather (moe dispatch)",
     r"[Ss]ort|[Rr]adix|[Ii]ndex|[Ss]catter|[Gg]ather"),
    ("fp32 GEMMs (the scan's C.h readout, dt_proj, logits)",
     r"f32f32_f32f32|sgemm|gemv|gemmSN"),
    ("bf16 GEMMs (projections, conv taps, experts)", r"bf16|nvjet|gemm"),
    ("NaN fills (deterministic mode)", r"[Ff]ill"),
    ("elementwise, copies, cat (the scan's exp and combines, gates)", r""))


def spans(names):
    """``with`` block: each ``(module, function name, span)`` of ``names``
    runs inside ``torch.profiler.record_function(span)``, so a profile
    reads the device time under it."""
    import contextlib
    from unittest import mock
    from torch.profiler import record_function
    stack = contextlib.ExitStack()
    for mod, fn_name, span in names:
        real = getattr(mod, fn_name)

        def run(*a, _real=real, _span=span, **kw):
            with record_function(_span):
                return _real(*a, **kw)

        stack.enter_context(mock.patch.object(mod, fn_name, run))
    return stack


def family_profile(torch, M, params, cfg, prompt_toks):
    """One prefill and one decode step of a full-size ssm or hybrid model
    under ``torch.profiler``: window, busy share, kernels, device ms by kind
    (``FAMILY_KERNEL_KINDS``), the top kernels, and the device time the
    Mamba mixers (``ssm.apply_ssm`` / ``apply_ssm_step``, projections
    included) and the selective scan's chunks (``ssm._chunk``: exp, b, the
    associative scan, the readout) span on the card (their spans' device
    annotations, which are not kernels); the prefill's flash forward
    kernels held to ``prefill_fwd_kernels``, the decode step's to none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import greedy
    from repro_torch.models import ssm as SSM
    from repro_torch.models.runtime import DEFAULT
    B, P = prompt_toks.shape
    state = {}

    def pre():
        cache = M.init_cache(cfg, B, P + SERVE["tokens"] + 8, device="cuda")
        logits, state["cache"] = M.prefill(params, cfg, DEFAULT,
                                           {"tokens": prompt_toks}, cache)
        state["tok"] = greedy(logits)

    def dec():
        M.decode_step(params, cfg, DEFAULT, state["tok"], state["cache"], P)

    out = {}
    with torch.no_grad():
        pre()
        dec()
        for key, fn in (("prefill", pre), ("decode", dec)):
            torch.cuda.synchronize()
            with spans(((SSM, "apply_ssm", "ssm_mixer"),
                        (SSM, "apply_ssm_step", "ssm_mixer"),
                        (SSM, "_chunk", "ssm_scan"))), \
                    profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - t0) * 1e3
            device = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
            under = {k: sum(e.time_range.elapsed_us() for e in device
                            if e.name == k) / 1e3
                     for k in ("ssm_mixer", "ssm_scan")}
            kernels = [e for e in device if e.name not in under]
            check(bool(kernels), f"the profiled {key} recorded no kernel")
            by_name = {}
            for e in kernels:
                n, t = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
            busy_ms = sum(t for _, t in by_name.values())
            kinds = dict.fromkeys((k for k, _ in FAMILY_KERNEL_KINDS), 0.0)
            for name, (_, t) in by_name.items():
                kinds[next(k for k, pat in FAMILY_KERNEL_KINDS
                           if re.search(pat, name))] += t
            print(f"[profile] {cfg.name} one {key} (B={B}, {P} prompt "
                  f"tokens): window {window_ms:.2f} ms, device busy "
                  f"{busy_ms:.2f} ms ({100 * busy_ms / window_ms:.1f}%), "
                  f"{len(kernels)} kernels; the Mamba mixers span "
                  f"{under['ssm_mixer']:.3f} ms of the card's time, the "
                  f"selective scan's chunks {under['ssm_scan']:.3f} ms "
                  f"({100 * under['ssm_scan'] / window_ms:.1f}% of the "
                  f"window); by kind: " +
                  ", ".join(f"{k} {t:.3f} ms" for k, t in kinds.items()))
            for name, (n, t) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1])[:8]:
                print(f"[profile]   {t:.3f} ms in {n} x {name[:90]}")
            out[key] = dict(window_ms=window_ms, busy_ms=busy_ms,
                            kernels=len(kernels), kinds=kinds,
                            mixer_ms=under["ssm_mixer"],
                            scan_ms=under["ssm_scan"],
                            rmsnorm_ms=per_launch_ms(by_name, "rmsnorm_"),
                            flash_ms=per_launch_ms(by_name, "flash_kernel"),
                            fwd_kernels=check_fwd_kernels(
                                f"{cfg.name} one {key}", by_name,
                                prefill_fwd_kernels(cfg) if key == "prefill"
                                else {}))
    return out


def rms_held(torch, RN, ref, rows, d, tag):
    """``rmsnorm`` at [rows, d] bf16 against its plain version at TOL,
    timed beside it, ``F.rms_norm`` and the bound."""
    x = randn(torch, (rows, d), torch.bfloat16, seed=9)
    sc = randn(torch, (d,), torch.bfloat16, seed=10)
    err = held(torch, f"rmsnorm {tag} [{rows}, {d}] bfloat16 ({d // 8} "
               f"pieces of 8)", RN.rmsnorm(x, sc), ref.rmsnorm(x, sc),
               TOL["bfloat16"], TOL["bfloat16"])
    ms = median_ms(lambda: RN.rmsnorm(x, sc), torch, reps=20, inner=10)
    plain_ms = median_ms(lambda: ref.rmsnorm(x, sc), torch, reps=10, inner=5)
    lib_ms = median_ms(lambda: lib_rmsnorm(x, sc), torch, reps=20, inner=10)
    bound, by = rms_bound_ms(rows, d, 2)
    print(f"[kernel] rmsnorm time {tag} [{rows}, {d}] bf16: kernel "
          f"{ms:.5f} ms ({ms / bound:.2f}x the bound {bound:.6f} ms, {by}), "
          f"plain {plain_ms:.4f} ms, F.rms_norm {lib_ms:.5f} ms")
    return dict(shape=[rows, d], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


def served_flash_shape(cfg, traffic):
    """(B, S, H, Kv, hd, causal) of a served model's prefill attention
    under ``traffic``: over the prompt (after a vlm model's patches),
    causal; an encdec model's encoder's, over its frames, non-causal."""
    from repro_torch.launch.serve import prefix_len
    B, H, Kv, hd = traffic["batch"], cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.family == "encdec":
        return (B, cfg.encoder_seq, H, Kv, hd, False)
    return (B, prefix_len(cfg) + traffic["prompt"], H, Kv, hd, True)


def hold_family_kernels(torch, cfg, traffic=SERVE):
    """Each kernel of a served model at the shapes and in the instantiation
    its main path runs, against the plain version: with RMSNorm, rmsnorm in
    bf16 at the prefill's [B·S, d_model] and a decode step's [B, d_model]
    (``rms_held``; at d_model 4,096 ``rmsnorm_row_kernel<bf16, 2>``, 512
    16-byte pieces over 256 threads; at 896, 112 pieces, the warp-a-row
    kernel); with attention layers, the flash forward at the prefill's
    shape (``served_flash_shape``) on the wgmma route (``flash_held``).
    Returns {"rmsnorm": {"prefill", "decode"}, "flash"}, each key where the
    model runs that kernel."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import prefix_len
    out = {}
    if cfg.norm == "rmsnorm":
        rows = traffic["batch"] * (prefix_len(cfg) + traffic["prompt"])
        out["rmsnorm"] = {key: rms_held(torch, RN, ref, n, cfg.d_model,
                                        f"{cfg.name} {key}")
                          for key, n in (("prefill", rows),
                                         ("decode", traffic["batch"]))}
    if attention_layers(cfg):
        out["flash"] = flash_held(torch, FA, ref,
                                  served_flash_shape(cfg, traffic),
                                  f"{cfg.name} prefill")
    torch.cuda.empty_cache()
    return out


def phase_serve_family(torch, K, T, smi, arch, cuts, want_params,
                       fp32_cuts):
    """A full-width ssm or hybrid model (``arch`` with ``cuts``) served
    through ``launch/serve.py::serve`` with qwen's traffic (``SERVE``) and
    every count set to 0 just before and read just after: rmsnorm norm1
    (and norm2 outside the ssm family) a layer and the final norm each
    prefill and decode step, one flash launch per attention layer a
    prefill, all on ``wgmma`` and none writing lse, no backward launch.
    Then, on the same weights: the decode bound from the weights' bytes,
    the kernel path against the plain path teacher-forced (the expert
    choices replayed where there are experts, the dropped assignments
    printed; the whole path's distance printed ungated, since the model's
    two bf16 plain versions lie farther apart than the bf16 gate, and with
    experts the flash kernel alone held at it) and a profiled prefill and
    decode step. The kernels are held at the model's shapes
    (``hold_family_kernels``), and the model in fp32, cut by ``fp32_cuts``
    to fit, at the fp32 gate (``phase_serve_fp32``)."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models import model as M

    full = C.get(arch)
    cfg = full.replace(**cuts)
    n_params = M.param_count(cfg)
    n_active = M.param_count(cfg, active_only=True)
    check((n_params, n_active) == want_params,
          f"{cfg.name}: {n_params} / {n_active} parameters, expected "
          f"{want_params}")
    base_gb = phase_memory(torch, f"serve {cfg.name}")
    reset_counts(K, T)
    t0 = time.perf_counter()
    res = serve(cfg, device="cuda", **SERVE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = serve_counts(K, T)
    routes = dict(FA.flash_attention.route_launches)
    lse_launches = FA.flash_attention.lse_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_batches = -(-SERVE["requests"] // SERVE["batch"])
    rms_run, attn = smoke_launches(cfg, SERVE["tokens"] * n_batches)
    want = dict(rmsnorm=rms_run, flash_attention=attn * n_batches,
                rmsnorm_bwd=0, others=0)
    prefill_ms = [t * 1e3 for t in res["prefill_s"]]
    decode_ms = [t / (SERVE["tokens"] - 1) * 1e3 for t in res["decode_s"]]
    tok_s = SERVE["requests"] * SERVE["tokens"] / (sum(res["prefill_s"]) +
                                                  sum(res["decode_s"]))
    toks = res["tokens"]
    cut = (f"{cfg.n_layers} of {full.n_layers} layers" if cuts else
           "the published size")
    print(f"[{cfg.family}] {cfg.name} {cut} ({n_params:,} parameters, "
          f"{n_active:,} active a token; d_model {cfg.d_model}, d_inner "
          f"{cfg.d_inner()}, d_state {cfg.ssm.d_state}, scan chunk "
          f"{cfg.ssm.chunk}, {cfg.dtype}), requests={SERVE['requests']} "
          f"batch="
          f"{SERVE['batch']} prompt={SERVE['prompt']} tokens="
          f"{SERVE['tokens']}: prefill ms per batch "
          f"{', '.join(f'{t:.2f}' for t in prefill_ms)}; decode ms per "
          f"token step {', '.join(f'{t:.3f}' for t in decode_ms)}; "
          f"{tok_s:.1f} tok/s over the run (wall {wall_s:.1f} s with the "
          f"weights' init); peak memory {peak_gb:.2f} GB ({base_gb:.3f} GB "
          f"allocated before the phase); launches {counts} (expected "
          f"{want}), flash_attention by route {routes}")
    check(counts == want and res["launches"] == {
        k: v for k, v in want.items() if k != "others"},
        f"{cfg.name} serve launches {counts} / {res['launches']}, expected "
        f"{want}")
    check(routes == dict(dict.fromkeys(routes, 0),
                         wgmma=want["flash_attention"]),
          f"{cfg.name} serve flash routes {routes}: every launch should run "
          f"wgmma")
    check(lse_launches == 0, f"{lse_launches} serve launches wrote lse")
    check(tuple(toks.shape) == (SERVE["requests"], SERVE["tokens"]) and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"served tokens {tuple(toks.shape)} out of shape or range")

    print(f"[{cfg.family}] {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          f"allocated once serve() returned")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SERVE["seed"]), "cuda")
    w_bytes = weight_bytes(params)
    decode_bound_ms = w_bytes / PEAK_BYTES_S * 1e3
    print(f"[{cfg.family}] {smi}: decode {min(decode_ms):.3f} ms a step at "
          f"best against its bound {decode_bound_ms:.3f} ms (every step "
          f"reads all {w_bytes / 1e9:.2f} GB of weights; "
          f"{w_bytes / 1e9 / (min(decode_ms) / 1e3) / 1e3:.2f} TB/s "
          f"achieved)")
    prompts = make_prompts(cfg, SERVE["requests"], SERVE["prompt"],
                           SERVE["seed"])
    routed = cfg.moe.num_experts > 0
    worst, drops, alone = 0.0, None, {}
    book = RouteBook() if routed else None
    for b0 in range(0, SERVE["requests"], SERVE["batch"]):
        p = torch.from_numpy(np.stack(prompts[b0:b0 + SERVE["batch"]])).cuda()
        g = toks[b0:b0 + SERVE["batch"]].cuda()
        err, same, _ = hold_logits(torch, M, params, cfg, p, g,
                                f"{cfg.name} requests {b0}-"
                                f"{b0 + SERVE['batch'] - 1}", book=book,
                                gate_path=False)
        check(same, "the kernel path gave other tokens on a second run")
        worst = max(worst, err)
        if routed:
            alone = {k: max(v, alone.get(k, 0.0))
                     for k, v in book.alone.items()}
            if drops is None:
                drops = served_drops(torch, book, cfg, f"[{cfg.family}]")
    batch0 = torch.from_numpy(np.stack(prompts[:SERVE["batch"]])).cuda()
    prof = family_profile(torch, M, params, cfg, batch0)
    del params, batch0
    kern = hold_family_kernels(torch, cfg)
    rms_err = max(r["max_abs_err"] for r in kern["rmsnorm"].values())
    attn = kern.get("flash")
    fp32_err, _ = phase_serve_fp32(torch, full.replace(dtype="float32",
                                                       **fp32_cuts))
    return dict(n_params=n_params, n_active=n_active, cuts=cuts,
                counts=counts, routes=routes, prefill_ms=prefill_ms,
                decode_ms=decode_ms, decode_bound_ms=decode_bound_ms,
                tok_s=tok_s, peak_gb=peak_gb, base_gb=base_gb,
                logit_err=worst, logit_err_alone=alone, drops=drops,
                route_flips=book.flips if routed else None,
                fp32_logit_err=fp32_err, rmsnorm_err=rms_err, attention=attn,
                profile=prof)


def phase_serve_ssm(torch, K, T, smi):
    """falcon-mamba-7b at its published size (no reduction): 65 rmsnorm
    launches a prefill or decode step (64 norm1 + the final norm), no
    flash launch; the kernel held at the model's shapes, and the model in
    fp32 at 1e-4."""
    return phase_serve_family(torch, K, T, smi, SSM_ARCH, {},
                              (SSM_PARAMS, SSM_PARAMS), fp32_cuts={})


def phase_serve_hybrid(torch, K, T, smi):
    """jamba-v0.1-52b cut to two 8-layer periods (``HYBRID_CUTS``): 33
    rmsnorm launches a step (norm1 + norm2 of 16 layers + the final norm),
    2 flash launches a prefill (layers 4 and 12), the expert choices
    replayed in the plain runs; the kernels held at the model's shapes, the
    flash kernel alone end to end at the bf16 gate, and one period
    (``HYBRID_FP32_CUTS``) in fp32 at 1e-4."""
    return phase_serve_family(torch, K, T, smi, HYBRID_ARCH, HYBRID_CUTS,
                              HYBRID_PARAMS, fp32_cuts=HYBRID_FP32_CUTS)


# falcon-mamba-7b's training cut: depth 64 -> 4 layers at full width and
# vocabulary (65,024); (all, active) parameters. Its traffic is stablelm's
# (TRAIN)
SSM_TRAIN_CUTS = dict(n_layers=4)
SSM_TRAIN_PARAMS = (953_929_728, 953_929_728)
# a warm-up step and a timed one: a step takes ~20 s (host-bound)
SSM_TRAIN_STEPS = 2


def phase_train_ssm(torch, K, T, smi):
    """falcon-mamba-7b at full width and vocabulary cut to 4 layers
    (``SSM_TRAIN_CUTS``) through ``launch/train.py::run_arch`` with
    stablelm's traffic (``TRAIN``: AdamW, 8 x 4,096 tokens, remat on),
    every count set to 0 just before and read just after: rmsnorm (2 L + 1)
    and rmsnorm_bwd (L + 1) x 2 launches a microbatch (norm1 a layer, run
    again under remat, and the final norm), no flash launch. Seconds a
    step, tokens/s, peak memory. Then one microbatch of the step (its own
    1 x 4,096 tokens; a whole step's profile takes minutes to read back)
    profiled: kernels, the device's busy share, the device time of the
    kernels inside the selective scan's chunks, forward and remat's
    recompute (``spans``); its loss and every gradient leaf against the
    all-plain microbatch (plain RMSNorm forward and backward) at 2e-2,
    beside the distance of two plain versions (the plain run with
    ``F.rms_norm``): gated where that noise floor lies within the gate,
    printed otherwise (the kernel alone is held at the step's own rows in
    ``phase_rmsnorm_bwd``, ``RMS_BWD_SHAPES``)."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import steps as ST
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch import train as TR
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SSM
    from repro_torch.models.runtime import Runtime
    from repro_torch.optim import make as make_opt

    t_phase = time.perf_counter()
    full = TR.arch_config(SSM_ARCH, full=True)
    cfg = full.replace(**SSM_TRAIN_CUTS)
    n_params = M.param_count(cfg)
    n_active = M.param_count(cfg, active_only=True)
    check((n_params, n_active) == SSM_TRAIN_PARAMS,
          f"{n_params} / {n_active} parameters, expected {SSM_TRAIN_PARAMS}")
    phase_memory(torch, f"train {cfg.name} ({cfg.n_layers} layers)")
    reset_counts(K, T)
    n = SSM_TRAIN_STEPS
    res = TR.run_arch(cfg, steps=n, label=f"{cfg.n_layers} layers, full "
                      f"width", remat=True, device="cuda", **TRAIN)
    counts = dict(flash=FA.flash_attention.launches,
                  flash_bwd=FA.flash_attention_bwd.launches,
                  rmsnorm=RN.rmsnorm.launches,
                  rmsnorm_bwd=RN.rmsnorm_bwd.launches,
                  others=K.lstm_cell.launches + K.lstm_seq.launches +
                  K.lstm_seq_bwd.launches + T.ternary_encode.launches +
                  T.ternary_decode.launches + T.ef_compress_leaves.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L, micro = cfg.n_layers, TRAIN["micro"]
    norms = layer_norms(cfg)
    step = {"flash_attention": 0, "flash_lse": 0, "flash_bwd": 0,
            "rmsnorm": (2 * norms + 1) * micro,
            "rmsnorm_bwd": (norms + 1) * micro * RN.BWD_LAUNCHES}
    want = dict(flash=0, flash_bwd=0, rmsnorm=step["rmsnorm"] * n,
                rmsnorm_bwd=step["rmsnorm_bwd"] * n, others=0)
    print(f"[ssm-train] launches over {n} steps {counts} (expected {want}: "
          f"{norms + 1} rmsnorm backward calls a microbatch, "
          f"{RN.BWD_LAUNCHES} launches each); per step {res['launches']}")
    check(counts == want and all(s == step for s in res["launches"]),
          f"ssm training launches {counts}, expected {want}")
    check(all(math.isfinite(x) for x in res["losses"]),
          f"non-finite losses {res['losses']}")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    timed = res["step_s"][1:]
    step_s = statistics.mean(timed)
    print(f"[ssm-train] {smi}: {cfg.name} cut to {L} of {full.n_layers} "
          f"layers at full width ({n_params:,} parameters; d_inner "
          f"{cfg.d_inner()}, d_state {cfg.ssm.d_state}, scan chunk "
          f"{cfg.ssm.chunk}), bf16, batch {TRAIN['batch']} x "
          f"{TRAIN['seq']} in {res['n_micro']} microbatches, AdamW, "
          f"remat: s per step {', '.join(f'{t:.3f}' for t in res['step_s'])}"
          f" (first: warm-up); timed mean {step_s:.3f} s, "
          f"{tokens / step_s:.0f} tokens/s; peak memory {peak_gb:.2f} GB; "
          f"losses {[round(x, 4) for x in res['losses']]}")
    params = res["params"]
    del res
    torch.cuda.empty_cache()

    # one microbatch of the step (1 x 4,096 tokens, the step's own shape a
    # microbatch): the profile of a whole step takes minutes to read back
    rows = TRAIN["batch"] // micro
    shape = InputShape("train", TRAIN["seq"], rows, "train")
    batch = TR.sample_batch(np.random.RandomState(TRAIN["seed"]),
                            M.train_batch_spec(cfg, shape), cfg.vocab,
                            "cuda")
    grads_fn = ST.bind_train(host_mesh(), cfg, Runtime(),
                             make_opt(TRAIN["optimizer"], TRAIN["lr"]),
                             shape, num_microbatches=1)["grads"]

    def kernel_step():
        with spans(((SSM, "apply_ssm", "ssm_mixer"),
                    (SSM, "_chunk", "ssm_scan"))):
            return grads_fn(params, batch)

    prof = train_profile(torch, kernel_step, {},
                         annotations=("ssm_mixer", "ssm_scan"))
    grads_k, mets_k = prof.pop("out")
    scan_ms, mixer_ms = prof["under"]["ssm_scan"], prof["under"]["ssm_mixer"]
    busy_share = prof["busy_ms"] / prof["window_ms"]
    scan_share = scan_ms / prof["busy_ms"]
    print(f"[ssm-train] one profiled microbatch ({rows} x {TRAIN['seq']}"
          f" tokens, 1/{micro} of a step): {prof['kernels']} kernels (x "
          f"{micro} = {prof['kernels'] * micro} a step), device busy "
          f"{prof['busy_ms']:.1f} of {prof['window_ms']:.1f} ms "
          f"({100 * busy_share:.1f}%); kernels inside the Mamba mixers' "
          f"forward and remat's recompute {mixer_ms:.1f} ms, inside the "
          f"selective scan's chunks {scan_ms:.1f} ms ({100 * scan_share:.1f}"
          f"% of the device's busy time; the backward nodes are not spanned)"
          f"; the profiler handed its events over in {prof['parse_s']:.1f} s")
    with plain_kernels():
        grads_p, mets_p = grads_fn(params, batch)
    with plain_kernels(rmsnorm=lib_rmsnorm):
        grads_f, mets_f = grads_fn(params, batch)
    loss_k, loss_p = float(mets_k["loss"]), float(mets_p["loss"])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    floor_rel = abs(float(mets_f["loss"]) - loss_p) / abs(loss_p)
    names = ["/".join(map(str, pth)) for pth in tree.leaf_paths(grads_k)]
    errs = [rel_err(torch, a, b) for a, b in zip(tree.leaves(grads_k),
                                                 tree.leaves(grads_p))]
    noise = [rel_err(torch, a, b) for a, b in zip(tree.leaves(grads_f),
                                                  tree.leaves(grads_p))]
    gated = max(noise) <= TRAIN_GRAD_TOL and floor_rel <= TRAIN_LOSS_RTOL
    ok = max(errs) <= TRAIN_GRAD_TOL and loss_rel <= TRAIN_LOSS_RTOL
    top = max(range(len(errs)), key=errs.__getitem__)
    print(f"[ssm-train] the microbatch's kernel step vs the all-plain step: "
          f"loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}, tol "
          f"{TRAIN_LOSS_RTOL}); worst of {len(errs)} gradient leaves "
          f"max|diff| / max|g| {errs[top]:.3e} at {names[top]} (tol "
          f"{TRAIN_GRAD_TOL}); two plain versions (F.rms_norm for the plain "
          f"RMSNorm) lie {max(noise):.3e} apart at their worst leaf, loss "
          f"rel {floor_rel:.3e}: " + (("gated " + ("ok" if ok else "FAIL"))
                                      if gated else "printed, not gated"))
    if gated:
        check(ok, f"the {cfg.name} training step through the kernels "
                  f"disagrees with the all-plain step")
    del grads_k, grads_p, grads_f, params, batch
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[ssm-train] phase took {phase_s:.1f} s")
    return dict(n_params=n_params, cuts=SSM_TRAIN_CUTS, step_s=step_s,
                phase_s=phase_s,
                steps_s=timed, tokens_s=tokens / step_s, peak_gb=peak_gb,
                counts=counts, launches_per_step=step, profile=prof,
                kernels_per_step=prof["kernels"] * micro,
                scan_ms=scan_ms, mixer_ms=mixer_ms, scan_share=scan_share,
                busy_share=busy_share, grad_err=max(errs),
                grad_noise=max(noise), gated=gated, loss_rel=loss_rel)


def phase_train_moe(torch, K, T, smi):
    """deepseek-moe-16b at full width and vocabulary cut to 2 layers
    (``MOE_TRAIN_CUTS``) through ``launch/train.py::run_arch`` with
    stablelm's traffic (``TRAIN``: AdamW, 8 microbatches of 4,096 tokens,
    remat on), every count set to 0 just before and read just after: flash
    32 forward (all writing lse) and 32 backward launches a step, all on
    ``wgmma``; rmsnorm 72 and rmsnorm_bwd 80 (40 calls of 2 launches) a
    step. Seconds a step, tokens/s, model FLOP/s from the active
    parameters, peak memory; a profiled step; that step's loss and every
    gradient leaf against the all-plain step (forward, flash backward and
    RMSNorm backward plain) replaying its expert choices."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import steps as ST
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch import train as TR
    from repro_torch.models import model as M
    from repro_torch.models.runtime import Runtime
    from repro_torch.optim import make as make_opt

    full = TR.arch_config(MOE_ARCH, full=True)
    cfg = full.replace(**MOE_TRAIN_CUTS)
    n_params = M.param_count(cfg)
    n_active = M.param_count(cfg, active_only=True)
    check((n_params, n_active) == MOE_TRAIN_PARAMS,
          f"{n_params} / {n_active} parameters, expected {MOE_TRAIN_PARAMS}")
    phase_memory(torch, f"train {cfg.name} (2 layers)")
    reset_counts(K, T)
    res = TR.run_arch(cfg, steps=MOE_TRAIN_STEPS, label="2 layers, full width",
                      remat=True, device="cuda", **TRAIN)
    counts = dict(flash=FA.flash_attention.launches,
                  lse=FA.flash_attention.lse_launches,
                  routes=dict(FA.flash_attention.route_launches),
                  flash_bwd=FA.flash_attention_bwd.launches,
                  bwd_routes=dict(FA.flash_attention_bwd.route_launches),
                  rmsnorm=RN.rmsnorm.launches,
                  rmsnorm_bwd=RN.rmsnorm_bwd.launches,
                  others=K.lstm_cell.launches + K.lstm_seq.launches +
                  K.lstm_seq_bwd.launches + T.ternary_encode.launches +
                  T.ternary_decode.launches + T.ef_compress_leaves.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L, micro, n = cfg.n_layers, TRAIN["micro"], MOE_TRAIN_STEPS
    step = {"flash_attention": 2 * L * micro, "flash_lse": 2 * L * micro,
            "flash_bwd": L * micro * FA.BWD_LAUNCHES,
            "rmsnorm": (4 * L + 1) * micro,
            "rmsnorm_bwd": (2 * L + 1) * micro * RN.BWD_LAUNCHES}
    want = dict(flash=step["flash_attention"] * n,
                lse=step["flash_lse"] * n,
                routes=dict(dict.fromkeys(counts["routes"], 0),
                            wgmma=step["flash_attention"] * n),
                flash_bwd=step["flash_bwd"] * n,
                bwd_routes=dict(dict.fromkeys(counts["bwd_routes"], 0),
                                wgmma=step["flash_bwd"] * n),
                rmsnorm=step["rmsnorm"] * n,
                rmsnorm_bwd=step["rmsnorm_bwd"] * n, others=0)
    print(f"[moe-train] launches over {n} steps {counts} (expected {want}: "
          f"{(2 * L + 1) * micro} rmsnorm backward calls a step, "
          f"{RN.BWD_LAUNCHES} launches each); per step {res['launches']}")
    check(counts == want and all(s == step for s in res["launches"]),
          f"moe training launches {counts}, expected {want}")
    check(all(math.isfinite(x) for x in res["losses"]),
          f"non-finite losses {res['losses']}")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    timed = res["step_s"][1:]
    step_s = statistics.mean(timed)
    mflops = model_flops(n_active, tokens, L, cfg.n_heads, cfg.hd,
                         TRAIN["seq"])
    mfu = mflops / step_s / PEAK_BF16_FLOP_S
    print(f"[moe-train] {smi}: {cfg.name} cut to {L} of {full.n_layers} "
          f"layers at full width ({n_params:,} parameters, {n_active:,} "
          f"active), bf16, batch {TRAIN['batch']} x {TRAIN['seq']} in "
          f"{res['n_micro']} microbatches, AdamW, remat: s per step "
          f"{', '.join(f'{t:.3f}' for t in res['step_s'])} (first: "
          f"warm-up); timed mean {step_s:.3f} s, {tokens / step_s:.0f} "
          f"tokens/s; model FLOPs from active parameters {mflops / 1e12:.1f}"
          f" T a step, {mflops / step_s / 1e12:.1f} TFLOP/s = "
          f"{100 * mfu:.2f}% of the bf16 peak; peak memory {peak_gb:.2f} GB;"
          f" losses {[round(x, 4) for x in res['losses']]}")
    params = res["params"]
    del res
    torch.cuda.empty_cache()

    shape = InputShape("train", TRAIN["seq"], TRAIN["batch"], "train")
    batch = TR.sample_batch(np.random.RandomState(TRAIN["seed"]),
                            M.train_batch_spec(cfg, shape), cfg.vocab,
                            "cuda")
    grads_fn = ST.bind_train(host_mesh(), cfg, Runtime(),
                             make_opt(TRAIN["optimizer"], TRAIN["lr"]),
                             shape, num_microbatches=TRAIN["micro"])["grads"]
    book = RouteBook()

    def kernel_step():
        with recorded_routes(book):
            return grads_fn(params, batch)

    prof = train_profile(torch, kernel_step,
                         prefill_fwd_kernels(cfg, 2 * TRAIN['micro']))
    grads_k, mets_k = prof.pop("out")
    rms_bwd_launch_ms = prof["rmsnorm_bwd_ms"] / max(
        prof["rmsnorm_bwd_launches"], 1)
    with plain_kernels(), replayed_routes(book):
        grads_p, mets_p = grads_fn(params, batch)
    loss_k, loss_p = float(mets_k["loss"]), float(mets_p["loss"])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    names = ["/".join(map(str, pth)) for pth in tree.leaf_paths(grads_k)]
    errs = [rel_err(torch, a, b) for a, b in zip(tree.leaves(grads_k),
                                                 tree.leaves(grads_p))]
    ok = max(errs) <= TRAIN_GRAD_TOL and loss_rel <= TRAIN_LOSS_RTOL
    worst_leaf = names[errs.index(max(errs))]
    print(f"[moe-train] kernel step vs the all-plain step (expert choices "
          f"replayed over {book.calls} router calls; on its own the plain "
          f"step would have chosen {book.flips} (token, expert) pairs "
          f"otherwise): loss {loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{loss_rel:.3e}, tol {TRAIN_LOSS_RTOL}), aux "
          f"{float(mets_k['aux']):.6f} vs {float(mets_p['aux']):.6f}; worst "
          f"of {len(errs)} gradient leaves max|diff| / max|g| "
          f"{max(errs):.3e} at {worst_leaf} (tol {TRAIN_GRAD_TOL}); router "
          f"{max(e for e, nm in zip(errs, names) if 'router' in nm):.3e}, "
          f"experts {max(e for e, nm in zip(errs, names) if 'experts' in nm):.3e}"
          f", shared {max(e for e, nm in zip(errs, names) if 'shared' in nm):.3e}"
          f", norm scales {max(e for e, nm in zip(errs, names) if 'norm' in nm):.3e}"
          f" {'ok' if ok else 'FAIL'}; the {prof['rmsnorm_bwd_launches']} "
          f"rmsnorm_bwd launches of the profiled step "
          f"{prof['rmsnorm_bwd_ms']:.3f} ms of device time, "
          f"{rms_bwd_launch_ms:.4f} ms a launch")
    check(ok, "the moe training step through the kernels disagrees with the "
              "all-plain step")
    del grads_k, grads_p, params, batch
    torch.cuda.empty_cache()
    return dict(n_params=n_params, n_active=n_active, step_s=step_s,
                steps_s=timed, tokens_s=tokens / step_s,
                model_tflop_s=mflops / step_s / 1e12, mfu=mfu,
                peak_gb=peak_gb, counts=counts,
                launches_per_step=step, profile=prof,
                rmsnorm_bwd_device_ms=rms_bwd_launch_ms,
                grad_err=max(errs), loss_rel=loss_rel,
                route_flips=book.flips, cuts=MOE_TRAIN_CUTS)


# ---------------------------------------------------------------------------
# the encdec and vlm families: whisper-base and internvl2-1b, whole
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-base"
VLM_ARCH = "internvl2-1b"
# no reduction: both published models (0.14 and 1.26 GB of bf16 weights)
PREFIXED_PARAMS = {ENCDEC_ARCH: 70_655_488, VLM_ARCH: 629_663_872}
# serving, 8 requests in batches of 4, 16 greedy tokens each: whisper 30 s
# of audio (1,500 frame embeddings; the conv/mel front end stubbed) and a
# 64-token prompt, inside its 448-token decoder context; internvl2 256
# patch embeddings (the ViT and projector stubbed) ahead of qwen's 1,024
# prompt tokens
PREFIXED_SERVE = {ENCDEC_ARCH: dict(SERVE, prompt=64), VLM_ARCH: dict(SERVE)}
# training at full width, AdamW lr 1e-3, remat on: whisper 8 rows of 1,500
# frames + 448 tokens in 4 microbatches; internvl2 stablelm's traffic, 8 x
# 4,096 positions (256 patches + 3,840 tokens) in 8 microbatches; one
# warm-up step, then the rest timed
PREFIXED_TRAIN = {ENCDEC_ARCH: dict(TRAIN, seq=448, micro=4),
                  VLM_ARCH: dict(TRAIN)}
PREFIXED_TRAIN_STEPS = 3


def in_fresh_thread(torch, fn):
    """``fn()`` on a new thread (no CUDA context current until a CUDA call
    binds one), synchronized there; its result, or its exception
    raised here."""
    box = {}

    def run():
        try:
            box["out"] = fn()
            torch.cuda.synchronize()
        except BaseException as e:       # noqa: BLE001 (re-raised below)
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def phase_serve_prefixed(torch, K, T, smi, arch):
    """whisper-base or internvl2-1b at its published size served through
    ``launch/serve.py::serve`` (``PREFIXED_SERVE``: zero frames or patches,
    as the reference serves them) with every count set to 0 just before and
    read just after: one flash launch a self-attention layer a prefill (the
    encoder's non-causal ones too), all on ``wgmma`` and none writing lse;
    with RMSNorm norm1 + norm2 a layer and the final norm each prefill and
    decode step; no backward launch. Then, on the same weights: the decode
    bound from the weights' bytes, the kernel path against the plain path
    teacher-forced on the served tokens with the served inputs (the flash
    kernel alone gated at SERVE_LOGIT_TOL; the whole path gated too where
    the two plain versions lie closer than that, else printed), a
    profiled prefill and decode step, each kernel held at the model's
    shapes (``hold_family_kernels``), and the model in fp32, frames or
    patches drawn from the seed, at 1e-4 (``phase_serve_fp32``)."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import extra_inputs, make_prompts, serve
    from repro_torch.models import model as M

    cfg, traffic = C.get(arch), PREFIXED_SERVE[arch]
    n_params = M.param_count(cfg)
    check(n_params == PREFIXED_PARAMS[arch],
          f"{cfg.name}: {n_params} parameters, expected "
          f"{PREFIXED_PARAMS[arch]}")
    base_gb = phase_memory(torch, f"serve {cfg.name}")
    reset_counts(K, T)
    t0 = time.perf_counter()
    res = serve(cfg, device="cuda", **traffic)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = serve_counts(K, T)
    routes = dict(FA.flash_attention.route_launches)
    lse_launches = FA.flash_attention.lse_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    B, n_tok = traffic["batch"], traffic["tokens"]
    n_batches = -(-traffic["requests"] // B)
    rms_run, attn = smoke_launches(cfg, n_tok * n_batches)
    want = dict(rmsnorm=rms_run, flash_attention=attn * n_batches,
                rmsnorm_bwd=0, others=0)
    prefill_ms = [t * 1e3 for t in res["prefill_s"]]
    decode_ms = [t / (n_tok - 1) * 1e3 for t in res["decode_s"]]
    tok_s = traffic["requests"] * n_tok / (sum(res["prefill_s"]) +
                                           sum(res["decode_s"]))
    toks = res["tokens"]
    inputs = (f"{cfg.encoder_seq} frames" if cfg.family == "encdec" else
              f"{cfg.vision_prefix} patches")
    print(f"[{cfg.family}] {smi}: {cfg.name} the published size "
          f"({n_params:,} parameters; d_model {cfg.d_model}, "
          f"{cfg.n_heads} over {cfg.n_kv_heads} heads, hd {cfg.hd}, "
          f"{cfg.dtype}), requests={traffic['requests']} batch={B} "
          f"({inputs} +) prompt={traffic['prompt']} tokens={n_tok}: prefill "
          f"ms per batch {', '.join(f'{t:.2f}' for t in prefill_ms)}; "
          f"decode ms per token step "
          f"{', '.join(f'{t:.3f}' for t in decode_ms)}; {tok_s:.1f} tok/s "
          f"over the run (wall {wall_s:.1f} s with the weights' init); peak "
          f"memory {peak_gb:.2f} GB ({base_gb:.3f} GB allocated before the "
          f"phase); launches {counts} (expected {want}), flash_attention by "
          f"route {routes}")
    check(counts == want and res["launches"] == {
        k: v for k, v in want.items() if k != "others"},
        f"{cfg.name} serve launches {counts} / {res['launches']}, expected "
        f"{want}")
    check(routes == dict(dict.fromkeys(routes, 0),
                         wgmma=want["flash_attention"]),
          f"{cfg.name} serve flash routes {routes}: every launch should run "
          f"wgmma")
    check(lse_launches == 0, f"{lse_launches} serve launches wrote lse")
    check(tuple(toks.shape) == (traffic["requests"], n_tok) and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"served tokens {tuple(toks.shape)} out of shape or range")

    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        traffic["seed"]), "cuda")
    w_bytes = weight_bytes(params)
    decode_bound_ms = w_bytes / PEAK_BYTES_S * 1e3
    print(f"[{cfg.family}] {smi}: decode {min(decode_ms):.3f} ms a step at "
          f"best against its bound {decode_bound_ms:.4f} ms (every step "
          f"reads all {w_bytes / 1e9:.3f} GB of weights)")
    prompts = make_prompts(cfg, traffic["requests"], traffic["prompt"],
                           traffic["seed"])
    served_extra = extra_inputs(cfg, B, "cuda")
    worst, alone = 0.0, {}
    for b0 in range(0, traffic["requests"], B):
        p = torch.from_numpy(np.stack(prompts[b0:b0 + B])).cuda()
        g = toks[b0:b0 + B].cuda()
        err, same, dist = hold_logits(
            torch, M, params, cfg, p, g, f"{cfg.name} requests {b0}-"
            f"{b0 + B - 1}", gate_path=False, extra=served_extra,
            alone=True)
        check(same, "the kernel path gave other tokens on a second run")
        worst = max(worst, err)
        alone = {k: max(v, alone.get(k, 0.0)) for k, v in dist.items()}
    prof = serve_profile(torch, cfg, params, prompts[:B], served_extra)
    del params
    kernels = hold_family_kernels(torch, cfg, traffic)
    fp32_err, fp32_routes = phase_serve_fp32(
        torch, cfg.replace(dtype="float32"),
        prompt=min(traffic["prompt"], SERVE_FP32["prompt"]))
    return dict(n_params=n_params, counts=counts, routes=routes,
                prefill_ms=prefill_ms, decode_ms=decode_ms,
                decode_bound_ms=decode_bound_ms, tok_s=tok_s,
                peak_gb=peak_gb, base_gb=base_gb, logit_err=worst,
                logit_err_alone=alone, fp32_logit_err=fp32_err,
                fp32_routes=fp32_routes, kernels=kernels, profile=prof)


def prefixed_flops(cfg, batch_rows, seq):
    """A step's model FLOPs: 6 per parameter per position it runs over
    (whisper's encoder parameters over the frames, the rest over the
    tokens; internvl2's over patches and tokens), plus the attention
    products (forward 2, backward 4, 2 flops a multiply-add): causal
    self-attention over S/2 keys a query, whisper's encoder over all 1,500
    and its cross-attention over the 1,500 frames. Remat's recomputed
    forward is not counted."""
    from repro_torch import tree
    from repro_torch.models import model as M
    H, hd = cfg.n_heads, cfg.hd
    if cfg.family != "encdec":
        return model_flops(M.param_count(cfg), batch_rows * seq,
                           cfg.n_layers, H, hd, seq)
    p = M.init_params(cfg, None, "meta")
    enc = sum(t.numel() for t in tree.leaves(p["encoder"]))
    dec = M.param_count(cfg) - enc
    Se, L, Le = cfg.encoder_seq, cfg.n_layers, cfg.n_encoder_layers
    return (6 * enc * batch_rows * Se + 6 * dec * batch_rows * seq +
            12 * Le * H * hd * Se * Se * batch_rows +
            6 * L * H * hd * seq * seq * batch_rows +
            12 * L * H * hd * seq * Se * batch_rows)


def phase_train_prefixed(torch, K, T, smi, arch):
    """whisper-base or internvl2-1b at its published size through
    ``launch/train.py::run_arch`` (``PREFIXED_TRAIN``: AdamW, remat on),
    every count set to 0 just before and read just after: a flash forward
    launch a self-attention layer a microbatch, twice under remat, all
    writing lse, and a backward call of two launches, all on ``wgmma``; with
    RMSNorm, rmsnorm (4 L + 1) and rmsnorm_bwd (2 L + 1) x 2 launches a
    microbatch. Seconds a step, positions/s, model FLOP/s, peak memory; a
    profiled step; that step's loss (2e-2 rel) and every gradient leaf
    (2e-2 of its max |g|) against the all-plain step (forward, flash
    backward and RMSNorm backward plain)."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import steps as ST
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch import train as TR
    from repro_torch.models import model as M
    from repro_torch.models.runtime import Runtime
    from repro_torch.optim import make as make_opt

    cfg, traffic = TR.arch_config(arch, full=True), PREFIXED_TRAIN[arch]
    n_params = M.param_count(cfg)
    check(n_params == PREFIXED_PARAMS[arch],
          f"{n_params} parameters, expected {PREFIXED_PARAMS[arch]}")
    phase_memory(torch, f"train {cfg.name}")
    reset_counts(K, T)
    n = PREFIXED_TRAIN_STEPS
    res = TR.run_arch(cfg, steps=n, label="full", remat=True, device="cuda",
                      **traffic)
    counts = dict(flash=FA.flash_attention.launches,
                  lse=FA.flash_attention.lse_launches,
                  routes=dict(FA.flash_attention.route_launches),
                  flash_bwd=FA.flash_attention_bwd.launches,
                  bwd_routes=dict(FA.flash_attention_bwd.route_launches),
                  rmsnorm=RN.rmsnorm.launches,
                  rmsnorm_bwd=RN.rmsnorm_bwd.launches,
                  others=K.lstm_cell.launches + K.lstm_seq.launches +
                  K.lstm_seq_bwd.launches + T.ternary_encode.launches +
                  T.ternary_decode.launches + T.ef_compress_leaves.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    La, L, micro = attention_layers(cfg), cfg.n_layers, traffic["micro"]
    rms = cfg.norm == "rmsnorm"
    step = {"flash_attention": 2 * La * micro, "flash_lse": 2 * La * micro,
            "flash_bwd": La * micro * FA.BWD_LAUNCHES,
            "rmsnorm": (4 * L + 1) * micro if rms else 0,
            "rmsnorm_bwd": (2 * L + 1) * micro * RN.BWD_LAUNCHES if rms
            else 0}
    want = dict(flash=step["flash_attention"] * n, lse=step["flash_lse"] * n,
                routes=dict(dict.fromkeys(counts["routes"], 0),
                            wgmma=step["flash_attention"] * n),
                flash_bwd=step["flash_bwd"] * n,
                bwd_routes=dict(dict.fromkeys(counts["bwd_routes"], 0),
                                wgmma=step["flash_bwd"] * n),
                rmsnorm=step["rmsnorm"] * n,
                rmsnorm_bwd=step["rmsnorm_bwd"] * n, others=0)
    print(f"[{cfg.family}-train] launches over {n} steps {counts} (expected "
          f"{want}); per step {res['launches']}")
    check(counts == want and all(s == step for s in res["launches"]),
          f"{cfg.name} training launches {counts}, expected {want}")
    rows, seq = traffic["batch"], traffic["seq"]
    positions = rows * (seq + cfg.encoder_seq if cfg.family == "encdec"
                        else seq)
    timed = res["step_s"][1:]
    step_s = statistics.mean(timed)
    mflops = prefixed_flops(cfg, rows, seq)
    mfu = mflops / step_s / PEAK_BF16_FLOP_S
    print(f"[{cfg.family}-train] {smi}: {cfg.name} the published size "
          f"({n_params:,} parameters), bf16, {rows} rows of "
          f"{'1,500 frames + ' if cfg.family == 'encdec' else ''}{seq} "
          f"positions in {res['n_micro']} microbatches, AdamW, remat: s per "
          f"step {', '.join(f'{t:.3f}' for t in res['step_s'])} (first: "
          f"warm-up); timed mean {step_s:.3f} s, {positions / step_s:.0f} "
          f"positions/s; model FLOPs {mflops / 1e12:.2f} T a step, "
          f"{mflops / step_s / 1e12:.1f} TFLOP/s = {100 * mfu:.2f}% of the "
          f"bf16 peak; peak memory {peak_gb:.2f} GB; losses "
          f"{[round(x, 4) for x in res['losses']]}")
    check(all(math.isfinite(x) for x in res["losses"]),
          f"non-finite losses {res['losses']}")
    params = res["params"]
    del res
    torch.cuda.empty_cache()

    shape = InputShape("train", seq, rows, "train")
    batch = TR.sample_batch(np.random.RandomState(traffic["seed"]),
                            M.train_batch_spec(cfg, shape), cfg.vocab,
                            "cuda")
    grads_fn = ST.bind_train(host_mesh(), cfg, Runtime(),
                             make_opt(traffic["optimizer"], traffic["lr"]),
                             shape, num_microbatches=micro)["grads"]
    prof = train_profile(torch, lambda: grads_fn(params, batch),
                         prefill_fwd_kernels(cfg, 2 * micro))
    grads_k, mets_k = prof.pop("out")
    if prof["rmsnorm_bwd_launches"]:
        from repro_torch.kernels import rmsnorm as RN
        call_ms = prof["rmsnorm_bwd_ms"] / prof["rmsnorm_bwd_launches"] * \
            RN.BWD_LAUNCHES
        print(f"[{cfg.family}-train] rmsnorm_bwd in the profiled step: "
              f"{prof['rmsnorm_bwd_ms']:.4f} ms of device time a step over "
              f"{prof['rmsnorm_bwd_launches']} launches ({call_ms:.5f} ms a "
              f"call of {RN.BWD_LAUNCHES} launches)")
    with plain_kernels():
        grads_p, mets_p = grads_fn(params, batch)
    loss_k, loss_p = float(mets_k["loss"]), float(mets_p["loss"])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    names = ["/".join(map(str, pth)) for pth in tree.leaf_paths(grads_k)]
    gk, gp = dict(zip(names, tree.leaves(grads_k))), dict(
        zip(names, tree.leaves(grads_p)))

    def err_of(name):
        """max|kernel - plain| over the plain leaf's max|g|; but a key
        bias without RoPE (whisper's, and every cross-attention's) adds
        one constant to a query's scores over all keys, which the softmax
        takes out: its gradient is 0 and both steps' are rounding noise,
        so its difference is measured against the key projection's max
        |g| (the leaf ``wk`` beside it)."""
        ref_leaf = gp[name]
        if name.endswith("/bk") and (cfg.rope_fraction == 0 or
                                     "/cross/" in name):
            ref_leaf = gp[name[:-2] + "wk"]
        return ((gk[name].float() - gp[name].float()).abs().max() /
                ref_leaf.float().abs().max().clamp_min(1e-30)).item()

    errs = [err_of(nm) for nm in names]
    ok = max(errs) <= TRAIN_GRAD_TOL and loss_rel <= TRAIN_LOSS_RTOL
    top = max(range(len(errs)), key=errs.__getitem__)
    print(f"[{cfg.family}-train] kernel step vs the all-plain step: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}, tol "
          f"{TRAIN_LOSS_RTOL}); worst of {len(errs)} gradient leaves "
          f"max|diff| / max|g| {errs[top]:.3e} at {names[top]} (tol "
          f"{TRAIN_GRAD_TOL}) {'ok' if ok else 'FAIL'}")
    check(ok, f"the {cfg.name} training step through the kernels disagrees "
              f"with the all-plain step")
    del grads_k, grads_p, gk, gp, params, batch
    torch.cuda.empty_cache()
    return dict(n_params=n_params, step_s=step_s, steps_s=timed,
                positions_s=positions / step_s,
                model_tflop_s=mflops / step_s / 1e12, mfu=mfu,
                peak_gb=peak_gb, counts=counts, launches_per_step=step,
                profile=prof, grad_err=max(errs), loss_rel=loss_rel)


MESH_TRAIN_CUTS = dict(n_layers=2)    # stablelm-1.6b at full width
MESH_SERVE = dict(batch=4, prompt=1024, tokens=16, seed=0)
# the served legs at full width: (arch, layers)
MESH_SERVE_LEGS = ((SERVE_ARCH, SERVE_LAYERS), (MOE_ARCH, 2), (SSM_ARCH, 4))
MESH_PG_TIMEOUT_S = 120


class TimedCollectives:
    """For the ``with`` block, every collective of the SPMD layer
    (``spmd._collective``) between two CUDA events on the current stream,
    which a blocking NCCL call joins before and after: ``ms`` by kind
    once the block has ended (after a synchronize)."""

    def __init__(self, torch, SP):
        self.torch, self.SP, self.pairs, self.ms = torch, SP, [], {}

    def __enter__(self):
        torch, orig = self.torch, self.SP._collective
        self.orig = orig

        def timed(kind, out, inp, group):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            orig(kind, out, inp, group)
            e1.record()
            self.pairs.append((kind, e0, e1))

        self.SP._collective = timed
        return self

    def __exit__(self, *exc):
        self.SP._collective = self.orig
        self.torch.cuda.synchronize()
        self.ms = {k: sum(e0.elapsed_time(e1) for kind, e0, e1 in self.pairs
                          if kind == k) for k in self.SP.KINDS}


def bound_serve(torch, mesh, cfg, params, toks):
    """One batch of prompts ``toks`` prefilled and decoded greedily (``MESH_
    SERVE["tokens"]`` tokens) through ``bind_prefill`` / ``bind_decode`` on
    ``mesh``: (logits a step [tokens, B, V], tokens [tokens, B], the
    collectives issued by the prefill and by the decode steps: calls,
    bytes, ms by kind)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import spmd as SP
    from repro_torch.distributed import steps as ST
    from repro_torch.launch.serve import greedy
    from repro_torch.models import model as M
    from repro_torch.models.runtime import DEFAULT
    B, prompt, n = toks.shape[0], toks.shape[1], MESH_SERVE["tokens"]
    max_seq = prompt + n + 8
    pre = ST.bind_prefill(mesh, cfg, DEFAULT,
                          InputShape("prefill", prompt, B, "prefill"))
    dec = ST.bind_decode(mesh, cfg, DEFAULT,
                         InputShape("serve", max_seq, B, "decode"))
    params = SP.put(mesh, params, pre["param_specs"])
    cache = SP.put(mesh, M.init_cache(cfg, B, max_seq, device="cuda"),
                   dec["cache_specs"])
    coll = []
    SP.COLLECTIVES.reset()
    with TimedCollectives(torch, SP) as tc:
        logits, cache = pre["step"](params, {"tokens": toks}, cache)
    coll.append(dict(calls=dict(SP.COLLECTIVES.calls),
                     bytes=dict(SP.COLLECTIVES.bytes), ms=tc.ms))
    out_l, out_t = [logits], [greedy(logits)]
    SP.COLLECTIVES.reset()
    with TimedCollectives(torch, SP) as tc:
        for t in range(n - 1):
            logits, cache = dec["step"](params, cache, out_t[-1], prompt + t)
            out_l.append(logits)
            out_t.append(greedy(logits))
    coll.append(dict(calls=dict(SP.COLLECTIVES.calls),
                     bytes=dict(SP.COLLECTIVES.bytes), ms=tc.ms))
    return torch.stack(out_l), torch.stack(out_t), coll


def phase_mesh(torch, K, T):
    """The steps on a one-rank NCCL ``DeviceMesh`` ("cuda", (1, 1), over
    ("data", "model")), where every module whose spec splits it over
    ``model`` computes its shard between Megatron's entry and exit (at one
    rank: all of it, and every ``model`` collective issued on a group of
    one), against the same calls on the card's host mesh: (a) stablelm-1.6b
    at full width cut to 2 layers, one ``run_arch`` training step
    (``bind_train``; AdamW, 8 x 4,096 tokens, 8 microbatches, remat), its
    parameters stored as DTensors; (b) the same step under a
    ``seq_parallel`` policy (the residual stream a sequence shard: on the
    host mesh the same plain step as (a)'s); (c)-(e) one batch of 4 x
    1,024 prompt tokens prefilled and 15 tokens decoded through
    ``bind_prefill`` / ``bind_decode`` by phase 6's qwen1.5-110b cut to 4
    layers, deepseek-moe-16b cut to 2 (its experts on ``model``) and
    falcon-mamba-7b cut to 4 (its d_inner on ``model``), all at full width.
    Each bit-equal to the host mesh's (parameters and loss after the step;
    every step's logits and the tokens), every kernel launch count equal,
    and the collectives by kind as many as ``spmd.step_collectives``
    predicts from the specs (which counts the ``model`` all-reduces, so a
    run that skipped the route fails); their calls, bytes and device ms
    printed."""
    import datetime
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    import repro_torch.configs as C
    from repro_torch import tree
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import spmd as SP
    from repro_torch.distributed import steps as ST
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    tcfg = TR.arch_config(TRAIN_ARCH, full=True).replace(**MESH_TRAIN_CUTS)
    phase_memory(torch, f"mesh {tcfg.name}")

    def train_run(seq_parallel=False):
        reset_counts(K, T)
        SP.COLLECTIVES.reset()
        bind = ST.bind_train
        if seq_parallel:
            def bind_sp(mesh, *args, **kw):
                return bind(mesh, *args, policy=SH.ShardingPolicy.for_mesh(
                    mesh, seq_parallel=True), **kw)
            ST.bind_train = bind_sp
        try:
            with TimedCollectives(torch, SP) as tc:
                res = TR.run_arch(tcfg, steps=1, label="mesh", remat=True,
                                  device="cuda", **TRAIN)
        finally:
            ST.bind_train = bind
        return (res, dict(calls=dict(SP.COLLECTIVES.calls),
                          bytes=dict(SP.COLLECTIVES.bytes), ms=tc.ms),
                launch_counts())

    def launch_counts():
        return dict(flash=FA.flash_attention.launches,
                    lse=FA.flash_attention.lse_launches,
                    routes=dict(FA.flash_attention.route_launches),
                    flash_bwd=FA.flash_attention_bwd.launches,
                    rmsnorm=RN.rmsnorm.launches,
                    rmsnorm_bwd=RN.rmsnorm_bwd.launches,
                    others=serve_counts(K, T)["others"] -
                    FA.flash_attention_bwd.launches)

    def ms(c):
        return {k: round(v, 4) for k, v in c["ms"].items()}

    def collectives(c):
        return (f"collectives {c['calls']}, bytes {c['bytes']}, device ms "
                f"{ms(c)}")

    host_train, _, host_train_k = train_run()

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store_dir = tempfile.mkdtemp(prefix="mesh_store_")
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=MESH_PG_TIMEOUT_S))
    legs = {}
    try:
        mesh = make_host_mesh("cuda")
        check(isinstance(mesh, DeviceMesh) and tuple(mesh.shape) == (1, 1)
              and tuple(mesh.mesh_dim_names) == ("data", "model") and
              mesh.device_type == "cuda",
              f"make_host_mesh under the process group gave {mesh}")
        # NCCL starts a group's communicator at its first collective: start
        # each axis's here, so the steps' collective times exclude it
        for name in mesh.mesh_dim_names:
            dist.all_reduce(torch.zeros(1, device="cuda"),
                            group=mesh.get_group(name))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        print(f"[mesh] one-rank NCCL process group, DeviceMesh (1, 1) over "
              f"(data, model) and a communicator an axis in {init_s:.2f} s")

        # (a), (b) the training step, then under seq_parallel
        pshape = M.init_params(tcfg, None, "meta")
        for tag, sp in (("train", False), ("train_seq_parallel", True)):
            got, coll, got_k = train_run(sp)
            pol = SH.ShardingPolicy(("data", "model"), (1, 1),
                                    seq_parallel=sp)
            want = SP.step_collectives(pshape, SH.param_specs(pshape, pol),
                                       pol, passes=2, backward=True,
                                       micro=got["n_micro"])
            hp, mp = host_train["params"], got["params"]
            stored = all(isinstance(t, DTensor) for t in tree.leaves(mp))
            same_p = all(torch.equal(SP.local_of(a), b) for a, b in
                         zip(tree.leaves(mp), tree.leaves(hp), strict=True))
            same_loss = got["losses"] == host_train["losses"]
            print(f"[mesh] ({tag}) {tcfg.name} full width, "
                  f"{tcfg.n_layers} layers ({got['n_params']:,} parameters),"
                  f" one bind_train step{' under seq_parallel' if sp else ''}"
                  f" on the mesh vs the host mesh: loss {got['losses']} vs "
                  f"{host_train['losses']}, parameters bit-equal {same_p}, "
                  f"stored as DTensors {stored}; kernel launches {got_k} vs "
                  f"{host_train_k}; {collectives(coll)} (predicted {want}); "
                  f"step {got['step_s'][0]:.3f} s vs "
                  f"{host_train['step_s'][0]:.3f} s on the host mesh")
            check(same_loss and same_p and stored,
                  f"the mesh's training step ({tag}) is not bit-equal to "
                  f"the host mesh's")
            check(got_k == host_train_k and
                  got["launches"] == host_train["launches"],
                  f"mesh step ({tag}) launches {got_k}, host {host_train_k}")
            check(coll["calls"] == want,
                  f"mesh step ({tag}) collectives {coll['calls']}, "
                  f"predicted {want}")
            legs[tag] = dict(collectives=coll, launches=got_k,
                             step_s=got["step_s"][0])
            del hp, mp, got
        del host_train

        # (c)-(e) prefill and decode
        host = AbstractMesh((1, 1), ("data", "model"), torch.device("cuda"))
        pol = SH.ShardingPolicy(("data", "model"), (1, 1))
        for arch, layers in MESH_SERVE_LEGS:
            scfg = C.get(arch).replace(n_layers=layers)
            phase_memory(torch, f"mesh {scfg.name}")
            sparams = M.init_params(scfg, torch.Generator(
                device="cuda").manual_seed(MESH_SERVE["seed"]), "cuda")
            toks = torch.from_numpy(np.stack(make_prompts(
                scfg, MESH_SERVE["batch"], MESH_SERVE["prompt"],
                MESH_SERVE["seed"]))).cuda()
            runs = []
            for m in (host, mesh):
                reset_counts(K, T)
                runs.append(bound_serve(torch, m, scfg, sparams, toks) +
                            (launch_counts(),))
            (host_l, host_t, host_c, host_k), (mesh_l, mesh_t, mesh_c,
                                               mesh_k) = runs
            del sparams
            sshape = M.init_params(scfg, None, "meta")
            cshape = M.init_cache(scfg, MESH_SERVE["batch"],
                                  MESH_SERVE["prompt"] +
                                  MESH_SERVE["tokens"] + 8, device="meta")
            want = [SP.step_collectives(
                sshape, SH.param_specs(sshape, pol), pol, gather_logits=True,
                cache_shape=cshape, decode=decode) for decode in (False,
                                                                  True)]
            want[1] = {k: v * (MESH_SERVE["tokens"] - 1)
                       for k, v in want[1].items()}
            same_l = bool(torch.equal(mesh_l, host_l))
            same_t = bool(torch.equal(mesh_t, host_t))
            print(f"[mesh] (serve) {scfg.name} full width, {scfg.n_layers} "
                  f"layers: {MESH_SERVE['batch']} x {MESH_SERVE['prompt']} "
                  f"prompt tokens prefilled and {MESH_SERVE['tokens'] - 1} "
                  f"decoded on the mesh vs the host mesh: logits bit-equal "
                  f"{same_l} (max |diff| "
                  f"{float((mesh_l - host_l).abs().max()):.3e}), tokens "
                  f"equal {same_t}; kernel launches {mesh_k} vs {host_k}; "
                  f"prefill {collectives(mesh_c[0])} (predicted {want[0]}); "
                  f"decode steps {collectives(mesh_c[1])} (predicted "
                  f"{want[1]})")
            check(all(sum(c["calls"].values()) == 0 for c in host_c),
                  f"the host mesh issued collectives: {host_c}")
            check(same_l and same_t, f"the mesh's prefill and decode of "
                                     f"{scfg.name} are not bit-equal to the "
                                     f"host's")
            check(mesh_k == host_k,
                  f"mesh serve launches {mesh_k}, host {host_k}")
            check([c["calls"] for c in mesh_c] == want,
                  f"mesh serve collectives {[c['calls'] for c in mesh_c]}, "
                  f"predicted {want}")
            legs[f"serve {scfg.name}"] = dict(
                prefill=mesh_c[0], decode=mesh_c[1], launches=mesh_k)
            del host_l, mesh_l
    finally:
        dist.destroy_process_group()
    phase_s = time.perf_counter() - t_phase
    print(f"[mesh] phase in {phase_s:.1f} s")
    return dict(legs=legs, init_s=init_s, phase_s=phase_s)


def main() -> int:
    global PEAK_BYTES_S, PEAK_BF16_FLOP_S
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.configs as C
    from repro_torch import device as D
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import lstm_cell as K
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ternary as T
    from repro_torch.launch import mesh as LM
    PEAK_BYTES_S, PEAK_BF16_FLOP_S = LM.HBM_BW, LM.PEAK_FLOPS_BF16

    D.resolve("cuda")          # deterministic kernels, before cuBLAS starts
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.time()
    sources = [K.SOURCE, T.SOURCE, RN.SOURCE, FA.SOURCE, FA.BWD_SOURCE]
    kbuild.compile_sources(sources)
    for mod in (K, T, RN, FA):
        mod.build()
    FA.build_bwd()
    RN.build_bwd()
    print(f"[build] {', '.join(src.name for src in sources)} built (in "
          f"parallel) and loaded in {time.time() - t0:.1f} s")
    for src in sources:
        log = kbuild.log_path(src).read_text()
        for name, report in ptxas_report(log):
            print(f"[build] {src.name} {name}: {report}")
        # ptxas's notes where it serialized wgmma (C75xx)
        for line in log.splitlines():
            if re.search(r"\(C75\d\d\)", line):
                print(f"[build] {src.name} {line.strip()}")
    # the fp32 forward's kernel and bf16's at hd 33-192 must keep their
    # wgmma in flight, the latter without a spill in each of its instances
    fa_log = kbuild.log_path(FA.SOURCE).read_text()
    serial = [line for line in fa_log.splitlines()
              if re.search(r"\(C751[28]\)", line) and
              re.search(r"flash_kernel_tf32x3|flash_kernel_wgmma_pipe", line)]
    check(not serial, f"ptxas serialized flash_kernel_tf32x3's or "
                      f"flash_kernel_wgmma_pipe's wgmma: {serial}")
    pipe_regs = pipe_registers(FA)
    want_pipes = {fwd_pipe_instance(hd) for hd in FWD_PIPE_DIMS}
    print(f"[build] flash_kernel_wgmma_pipe: " + "; ".join(
        f"{n} {r}" for n, r in pipe_regs.items()))
    check(set(pipe_regs) == want_pipes and all(
        re.search(r"\b0 bytes spill stores, 0 bytes spill loads", r)
        for r in pipe_regs.values()),
          f"flash_kernel_wgmma_pipe spills or its instances {want_pipes} "
          f"were not all built: {pipe_regs}")
    # the backward's two-warpgroup kernels (bf16: dq at hd 128, dk/dv at hd
    # 64 and 128): their wgmma in flight (no note that ptxas serialized
    # them) and no spill
    bwd_log = kbuild.log_path(FA.BWD_SOURCE).read_text()
    serial = [line for line in bwd_log.splitlines()
              if re.search(r"\(C75\d\d\).*serialized", line) and
              "wgmma_pipe" in line]
    check(not serial, f"ptxas serialized the wgmma of the backward's "
                      f"two-warpgroup kernels: {serial}")
    bwd_pipe_regs = pipe_registers(FA, FA.BWD_SOURCE)
    print(f"[build] the backward's two-warpgroup kernels: " + "; ".join(
        f"{n} {r}" for n, r in bwd_pipe_regs.items()))
    check(len(bwd_pipe_regs) == 3 and all(
        re.search(r"\b0 bytes spill stores, 0 bytes spill loads", r)
        for r in bwd_pipe_regs.values()),
          f"the backward's two-warpgroup kernels spill or were not built: "
          f"{bwd_pipe_regs}")
    # the redesigned backward kernels (rmsnorm_bwd's rows kernels,
    # lstm_seq_bwd's staged kernel and its stamp instantiation): each
    # built, none spilling
    new_bwd = [(name, rep) for src in (RN.SOURCE, K.SOURCE)
               for name, rep in ptxas_report(kbuild.log_path(src).read_text())
               if any(k in name for k in NEW_BWD_KERNELS)]
    print(f"[build] the redesigned backward kernels: " + "; ".join(
        f"{n} {r}" for n, r in new_bwd))
    check(all(any(k in n for n, _ in new_bwd) for k in NEW_BWD_KERNELS) and
          all(re.search(r"\b0 bytes spill stores, 0 bytes spill loads", r)
              for _, r in new_bwd),
          f"a redesigned backward kernel spills or was not built: {new_bwd}")
    hgmma = {src.name: hgmma_count(src) for src in (FA.SOURCE,
                                                     FA.BWD_SOURCE)}
    for name, n in hgmma.items():
        print(f"[build] {name}: "
              f"{'not measured (no cuobjdump)' if n is None else n} "
              f"HGMMA (wgmma) instructions in the library's SASS")

    paper = paper_shapes()
    worst, rows = phase_kernel(torch, K, ref, paper)
    seq_err, seq_rows = phase_lstm_seq(torch, K, ref, paper)
    bwd_err, bwd_abs, bwd_rows = phase_lstm_bwd(torch, K, ref, paper)
    ceilings = phase_lstm_ceilings(torch, K, ref)
    tern = phase_ternary(torch, T, ref)
    rms_err, rms = phase_rmsnorm(torch, RN, ref)
    fa_err, fa = phase_flash(torch, FA, ref)
    fwd_pipe = flash_fwd_pipe_times(torch, FA, ref)
    split_launches = phase_flash_split(torch, FA, ref)
    phase_grad(torch, ref)
    phase_codec(torch, T)
    prob, (launches, cell_launches, bwd_launches), seq, dense_s = \
        phase_main_path(torch, K, T)
    tern_counts, per_version, wire_bytes = phase_wire_paths(
        torch, K, T, prob, seq, dense_s)
    prof = phase_profile(torch, prob)
    gw = phase_gateway(torch, K, T, per_version["none/inproc"]["mean"])
    analysis = phase_analysis()
    served = phase_serve(torch, K, T)
    serve_prof = serve_profile(torch, served["cfg"], served["params"],
                               served["prompts"][:SERVE["batch"]])
    del served["params"]       # each phase below starts with phase_memory
    fp32_err, fp32_routes = phase_serve_fp32(torch, C.get(SERVE_ARCH).replace(
        n_layers=SERVE_LAYERS, dtype="float32"))
    moe_served = phase_serve_moe(torch, K, T, smi)
    ssm_served = phase_serve_ssm(torch, K, T, smi)
    hybrid_served = phase_serve_hybrid(torch, K, T, smi)
    encdec_served = phase_serve_prefixed(torch, K, T, smi, ENCDEC_ARCH)
    vlm_served = phase_serve_prefixed(torch, K, T, smi, VLM_ARCH)
    phase_smoke_cpu(torch)
    torch.cuda.empty_cache()
    rms_bwd = phase_rmsnorm_bwd(torch, RN, ref)
    train_kern = phase_train_kernels(torch, FA, RN, ref)
    train = phase_train(torch, K, T)
    moe_train = phase_train_moe(torch, K, T, smi)
    encdec_train = phase_train_prefixed(torch, K, T, smi, ENCDEC_ARCH)
    vlm_train = phase_train_prefixed(torch, K, T, smi, VLM_ARCH)
    nemotron = phase_train_nemotron(torch, K, T, smi)
    ssm_train = phase_train_ssm(torch, K, T, smi)
    mesh = phase_mesh(torch, K, T)

    layer0, seq0 = rows[0], seq_rows[0]
    # a map's forward: one sequence launch per layer
    seq_map = {key: sum(r[key] for r in seq_rows) for key in (
        "ms", "plain_ms", "graph_ms", "cudnn_ms", "bound_ms")}
    kernels = [{
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:26",
        # the training path runs lstm_seq: no step launches there
        "launches": cell_launches, "max_abs_err": worst,
        "ms": layer0["ms"], "plain_ms": layer0["plain_ms"],
        "bound_ms": layer0["bound_ms"], "bound_by": layer0["bound_by"],
        "library_ms": layer0["library_ms"], "shape": layer0["shape"],
        "layer1": rows[1], "map_ms": prof["map_ms"],
        "seq_ms": seq0["ms"], "seq_bound_ms": seq0["bound_ms"],
        "graph_ms": seq0["graph_ms"], "cudnn_ms": seq0["cudnn_ms"],
        "seq_launches": launches, "seq_map": seq_map,
    }, {
        "name": "lstm_seq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:26",
        "launches": launches, "max_abs_err": seq_err,
        "ms": seq0["ms"], "plain_ms": seq0["plain_ms"],
        "bound_ms": seq0["bound_ms"], "bound_by": seq0["bound_by"],
        "library_ms": seq0["cudnn_ms"], "graph_ms": seq0["graph_ms"],
        "shape": seq0["shape"], "layer1": seq_rows[1], "map": seq_map,
        "device_ms": prof["seq_ms"], "map_ms": prof["map_ms"],
        "map_profile": prof["map_profile"],
        "gateway_launches": {k: gw[k]["lstm_seq"] for k in (
            "tcp", "ws", "local", "race")},
    }, {
        "name": "lstm_seq_bwd", "route": "cuda", "ceilings": ceilings,
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/models/lstm.py:68",
        "launches": bwd_launches, "max_abs_err": bwd_abs,
        "max_rel_err": bwd_err, "ms": bwd_rows[0]["ms"],
        "plain_ms": bwd_rows[0]["plain_ms"],
        "bound_ms": bwd_rows[0]["bound_ms"],
        "bound_by": bwd_rows[0]["bound_by"],
        # cuDNN nn.LSTM forward + backward, timed only
        "library_ms": bwd_rows[0]["cudnn_fwd_bwd_ms"],
        "fwd_bwd_ms": bwd_rows[0]["fwd_bwd_ms"],
        "shape": bwd_rows[0]["shape"], "layer1": bwd_rows[1],
        "kernel": "lstm_seq_bwd_staged_kernel",
        "yardstick": "lstm_seq_bwd_kernel",
        "yardstick_ms": bwd_rows[0]["yardstick_ms"],
        "launch_device_ms": bwd_rows[0]["device_ms"],
        "yardstick_device_ms": bwd_rows[0]["yardstick_device_ms"],
        "stamps": bwd_rows[0]["stamps"], "sweep": bwd_rows[0].get("sweep"),
        "device_ms": prof["bwd_ms"], "map_ms": prof["map_ms"],
        "gateway_launches": {k: gw[k]["lstm_seq_bwd"] for k in (
            "tcp", "ws", "local", "race")},
    }]
    # the main path's ternary counts: (ef, encode, decode) of the TernGrad
    # wire run
    for key, name, line, n_launch in (
            ("encode", "ternary_encode", 21, tern_counts[3]),
            ("decode", "ternary_decode", 31, tern_counts[4]),
            ("ef_compress", "ternary_ef_compress", 21, tern_counts[2])):
        r = tern[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ternary.cu",
            "replaces": f"src/repro/kernels/ternary.py:{line}",
            "launches": n_launch, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "n": r["n"], "sizes": r["sizes"],
            **{k: r[k] for k in r if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "n", "sizes",
                "max_abs_err")}})
    kernels[-1].update(
        also_replaces="src/repro/kernels/ternary.py:31",
        codec_ms=prof["codec_ms"], codec_kernels=prof["codec_kernels"],
        codec_busy_ms=prof["codec_busy_ms"],
        device_ms={"scale": prof["scale_ms"], "ef": prof["ef_ms"]})
    kernels.append({
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:16",
        "launches": served["counts"]["rmsnorm"], "max_abs_err": rms_err,
        **rms["prefill"],
        "device_ms": serve_prof["prefill"]["rmsnorm_ms"],
        "decode": dict(rms["decode"],
                       device_ms=serve_prof["decode"]["rmsnorm_ms"]),
        # the training path: stablelm-1.6b uses LayerNorm (no launch); the
        # smoke configs' counts are gated in phase_train_smoke
        "train": dict(train_kern["rmsnorm"],
                      launches_per_step=train["counts"]["rmsnorm"] //
                      TRAIN_STEPS,
                      moe_launches_per_step=moe_train[
                          "launches_per_step"]["rmsnorm"]),
        "moe_serve_launches": moe_served["counts"]["rmsnorm"],
        "family_max_abs_err": max(ssm_served["rmsnorm_err"],
                                  hybrid_served["rmsnorm_err"]),
        "moe_device_ms": {k: moe_served["profile"][k]["rmsnorm_ms"]
                          for k in ("prefill", "decode")},
        "ssm_serve_launches": ssm_served["counts"]["rmsnorm"],
        "hybrid_serve_launches": hybrid_served["counts"]["rmsnorm"],
        "ssm_device_ms": {k: ssm_served["profile"][k]["rmsnorm_ms"]
                          for k in ("prefill", "decode")},
        "hybrid_device_ms": {k: hybrid_served["profile"][k]["rmsnorm_ms"]
                             for k in ("prefill", "decode")},
        # internvl2-1b: d_model 896 on the warp-a-row kernel
        "vlm_serve_launches": vlm_served["counts"]["rmsnorm"],
        "vlm_train_launches_per_step":
            vlm_train["launches_per_step"]["rmsnorm"],
        "vlm_device_ms": {k: vlm_served["profile"][k]["rmsnorm_ms"]
                          for k in ("prefill", "decode")},
        "ssm_train_launches_per_step":
            ssm_train["launches_per_step"]["rmsnorm"],
        "internvl2": vlm_served["kernels"]["rmsnorm"]})
    rb = rms_bwd["4096x2048"]
    kernels.append({
        "name": "rmsnorm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        # jax.grad of the formula: the JAX package has no kernel for it
        "replaces": "src/repro/models/layers.py:45",
        "kernels": "rmsnorm_bwd_warp_kernel or rmsnorm_bwd_block_kernel "
                   "(the yardstick's rows kernels on other rows) + "
                   "rmsnorm_bwd_cols_kernel, one C call",
        "yardstick": "rmsnorm_bwd_row_kernel (or rmsnorm_bwd_any_kernel) "
                     "+ rmsnorm_bwd_cols_kernel",
        "host_us": rms_bwd["host_us"],
        # deepseek-moe-16b's 2-layer step: 40 calls of 2 launches a step
        "launches": moe_train["counts"]["rmsnorm_bwd"],
        "launches_per_step": moe_train["launches_per_step"]["rmsnorm_bwd"],
        "calls_per_step": moe_train["launches_per_step"]["rmsnorm_bwd"] //
        RN.BWD_LAUNCHES,
        "max_abs_err": rms_bwd["max_abs_err"],
        "max_rel_err": rms_bwd["max_rel_err"],
        "ms": rb["ms"], "plain_ms": rb["plain_ms"],
        "bound_ms": rb["bound_ms"], "bound_by": rb["bound_by"],
        # F.rms_norm's backward alone (torch.autograd.grad), timed only
        "library_ms": rb["library_ms"],
        "lib_fwd_bwd_ms": rb["lib_fwd_bwd_ms"], "shape": rb["shape"],
        "qwen_width": rms_bwd["4096x8192"],
        "device_ms": moe_train["rmsnorm_bwd_device_ms"],
        "vlm_train_launches_per_step":
            vlm_train["launches_per_step"]["rmsnorm_bwd"],
        # device ms a launch of each rmsnorm_bwd kernel in internvl2-1b's
        # profiled training step (d_model 896)
        "vlm_step_device_ms": {
            k: v for k, v in vlm_train["profile"]["bwd_kernels"].items()
            if k.startswith("rmsnorm_bwd")},
        "internvl2": rms_bwd["4096x896"],
        # falcon-mamba-7b's 4-layer step (norm1 a layer and the final norm)
        "ssm_train_launches_per_step":
            ssm_train["launches_per_step"]["rmsnorm_bwd"],
        "ssm_step_device_ms": {
            k: v for k, v in ssm_train["profile"]["bwd_kernels"].items()
            if k.startswith("rmsnorm_bwd")},
        "d_model_4096": rms_bwd["4096x4096"]})
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": served["counts"]["flash_attention"],
        "max_abs_err": fa_err, **fa,
        "device_ms": serve_prof["prefill"]["flash_ms"],
        "split_launches": split_launches,
        "moe_serve_launches": moe_served["counts"]["flash_attention"],
        "ssm_serve_launches": ssm_served["counts"]["flash_attention"],
        "hybrid_serve_launches": hybrid_served["counts"]["flash_attention"],
        "hybrid_routes": hybrid_served["routes"],
        "encdec_serve_launches": encdec_served["counts"]["flash_attention"],
        "vlm_serve_launches": vlm_served["counts"]["flash_attention"],
        "encdec_train_launches_per_step":
            encdec_train["launches_per_step"]["flash_attention"],
        "vlm_train_launches_per_step":
            vlm_train["launches_per_step"]["flash_attention"],
        "whisper": dict(encdec_served["kernels"]["flash"], device_ms=
                        encdec_served["profile"]["prefill"]["flash_ms"]),
        "internvl2": dict(vlm_served["kernels"]["flash"], device_ms=
                          vlm_served["profile"]["prefill"]["flash_ms"]),
        "hybrid_device_ms": hybrid_served["profile"]["prefill"]["flash_ms"],
        "jamba": hybrid_served["attention"],
        "moe_train_launches_per_step":
            moe_train["launches_per_step"]["flash_attention"],
        "deepseek": dict(moe_served["attention"],
                         device_ms=moe_served["profile"]["prefill"][
                             "flash_ms"]),
        "train": dict({a: train_kern[a] for a in TRAIN_FLASH_SHAPES},
                      lse_route_err=train_kern["lse_routes"],
                      launches_per_step=train["counts"]["flash"] //
                      TRAIN_STEPS,
                      lse_launches=train["counts"]["lse"],
                      no_remat_launches_per_step=train["no_remat_flash"]),
        "routes": {
            "wgmma": {"kernel": "flash_kernel_wgmma_pipe at hd 33-192, "
                                "flash_kernel_wgmma at 1-32 and 193-256",
                      "dtype": "bfloat16 up to hd 256",
                      "launches": served["routes"]["wgmma"], "ms": fa["ms"],
                      "hd256": fa["hd256"]["bfloat16"]},
            "wgmma_chunked": {"kernel": "flash_kernel_wgmma_cols",
                              "dtype": "bfloat16 above hd 256",
                              "launches": served["routes"]["wgmma_chunked"],
                              "hd576": fa["hd576"]["bfloat16"],
                              "hd1024": fa["hd1024"]["bfloat16"]},
            "tf32x3": {"kernel": "flash_kernel_tf32x3",
                       "dtype": "float32, every width",
                       "launches": fp32_routes["tf32x3"],
                       "launches_on": "the fp32 serve phase's greedy run",
                       **{f"hd{w}": fa[f"hd{w}"]["float32"]
                          for w in (128, *FLASH_HD_TIMED)}},
            "cuda_core": {"kernel": "flash_kernel",
                          "dtype": "bfloat16 at 2^31 - 256 folded rows or "
                                   "more; both dtypes' yardstick",
                          "launches": served["routes"]["cuda_core"]},
            "hd_chunked": {"kernel": "flash_kernel_chunked",
                           "dtype": "bfloat16 above hd 256 at 2^31 - 256 "
                                    "folded rows or more; both dtypes' "
                                    "yardstick",
                           "launches": served["routes"]["hd_chunked"]}},
        "hgmma_in_sass": hgmma[FA.SOURCE.name]})
    h192, nem = fa["hd192"]["bfloat16"], train_kern[NEMOTRON_ARCH]
    kernels.append({
        "name": "flash_attention_hd192", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "kernel": fwd_pipe_kernel(192, 8),
        "dtype": "bfloat16 at hd 129-192 (route wgmma)",
        # its main path: the one-layer nemotron-4-340b step's forwards
        "launches": nemotron["counts"]["fwd_routes"]["wgmma"],
        "max_abs_err": max(h192["max_abs_err"], nem["max_abs_err"],
                           fa["pipe_gate"]["max_abs_err"]),
        "lse_err": fa["pipe_gate"]["lse_err"],
        "ms": h192["ms"], "plain_ms": h192["plain_ms"],
        "bound_ms": h192["bound_ms"], "bound_by": h192["bound_by"],
        "library_ms": h192["library_ms"],
        "library_backend": h192["library_backend"],
        "shape": fa["shape"][:4] + [192],
        "yardstick": "flash_kernel_wgmma<192, 64>",
        "yardstick_ms": h192["yardstick_ms"], "registers": pipe_regs,
        "nemotron": {k: nem[k] for k in (
            "shape", "fwd_lse_ms", "fwd_ms", "fwd_bound_ms", "plain_fwd_ms",
            "yardstick_lse_ms", "yardstick_ms", "sdpa_fwd_ms",
            "sdpa_fwd_backend", "max_abs_err")},
        "device_ms": nemotron["fwd_device_ms_per_launch"],
        "launches_per_step": nemotron["counts"]["fwd_routes"]["wgmma"] //
        NEMOTRON_STEPS})
    # bf16 at hd 64 and 128: one entry for each instance of
    # flash_kernel_wgmma_pipe on the route, each at a shape that runs it
    # (ms by events over launches of the C functions alone, device_ms and
    # library_ms, SDPA's forward, by the profiler, null where no window
    # recorded), its launches the wrapper's count in its main path (every
    # forward there on that instance, as the profiles show): <64, 2> at
    # stablelm-1.6b's training shape and steps, <128, 3> at qwen1.5-110b's
    # B=4 prefill shape and serving; then the yardstick. The profiled
    # prefills' and steps' forward kernels, by name and count
    fwd_profiled = {
        "serve": {arch: r["profile"]["prefill"]["fwd_kernels"]
                  for arch, r in ((SERVE_ARCH, {"profile": serve_prof}),
                                  (MOE_ARCH, moe_served),
                                  (HYBRID_ARCH, hybrid_served),
                                  (ENCDEC_ARCH, encdec_served),
                                  (VLM_ARCH, vlm_served))},
        "train": {arch: r["profile"]["fwd_kernels"]
                  for arch, r in ((TRAIN_ARCH, train),
                                  (MOE_ARCH, moe_train),
                                  (ENCDEC_ARCH, encdec_train),
                                  (VLM_ARCH, vlm_train))}}

    def profiled_launches(names):
        return sum(n for paths in fwd_profiled.values()
                   for got in paths.values()
                   for k, n in got.items() if k in names)

    unrecorded = [name for name, r in fwd_pipe.items()
                  if r["device_ms"] is None or r["yardstick_device_ms"] is None]
    fwd_common = {"source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "replaces": "src/repro/kernels/flash_attention.py:30"}

    def fwd_figures(r, who=""):
        return {"ms": r[who + "ms"], "device_ms": r[who + "device_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "bound3_ms": r["bound3_ms"],
                "library_ms": r["sdpa_fwd_ms"], "shape": r["shape"],
                "with_lse": r["with_lse"]}

    for width, at, main_launches, per_step in (
            (64, "stablelm-1.6b train", train["counts"]["flash"],
             train["counts"]["flash"] // TRAIN_STEPS),
            (128, "qwen1.5-110b prefill", served["routes"]["wgmma"], None)):
        inst = fwd_pipe_instance(width)
        rows = [r for r in fwd_pipe.values() if r["kernel"] == inst]
        kernels.append({
            "name": f"flash_attention_hd{width}", "route": "cuda",
            **fwd_common, "kernel": inst,
            "dtype": f"bfloat16 at hd {width // 2 + 1}-{width}" +
                     (" with G > 1" if width == 128 else ""),
            "launches": main_launches, "launches_per_step": per_step,
            "profiled_launches": profiled_launches({inst}),
            **fwd_figures(fwd_pipe[at]),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "lse_err": max(r["lse_err"] for r in rows),
            "registers": pipe_regs[inst],
            "shapes": {n: r for n, r in fwd_pipe.items()
                       if r["kernel"] == inst}})
    yard_names = {f"flash_kernel_wgmma<{w}, 64>" for w in (64, 128)}
    kernels.append({
        "name": "flash_attention_hd64_128_yardstick", "route": "cuda",
        **fwd_common,
        "kernels": "flash_kernel_wgmma<64, 64>, flash_kernel_wgmma<128, 64> "
                   "through flash_attention_bf16_yardstick",
        # its kernels' launches in the profiled prefills and training
        # steps, where the route still runs one (flash_kernel_wgmma<128,
        # 64> at G = 1: deepseek-moe-16b); the C function itself is no
        # route's. Its figures: flash_kernel_wgmma<128, 64> at qwen1.5-
        # 110b's B=4 prefill shape
        "launches": profiled_launches(yard_names),
        **fwd_figures(fwd_pipe["qwen1.5-110b prefill"], "yardstick_"),
        "max_abs_err": max(r["yardstick_err"] for r in fwd_pipe.values()),
        "profiled_fwd_kernels": fwd_profiled,
        "unrecorded": unrecorded})
    lm = train_kern[TRAIN_ARCH]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:201",
        "launches": train["counts"]["flash_bwd"],
        "max_abs_err": lm["bwd_abs_err"], "max_rel_err": max(lm["bwd_err"]),
        "ms": lm["bwd_ms"], "plain_ms": lm["bwd_plain_ms"],
        "bound_ms": lm["bwd_bound_ms"], "bound_by": lm["bwd_bound_by"],
        # SDPA forward + backward, timed only
        "library_ms": lm["sdpa_fwd_bwd_ms"], "shape": lm["shape"],
        "fwd_bwd_ms": lm["fwd_bwd_ms"], "registers": lm["bwd_registers"],
        "routes": train["counts"]["bwd_routes"],
        "launches_per_step": train["counts"]["flash_bwd"] // TRAIN_STEPS,
        "device_ms_per_step": train["profile"]["flash_bwd_ms"],
        "sweep_err": train_kern["bwd_sweep_err"],
        "cuda_core_pair_err": train_kern["bwd_cc_err"],
        "wide": train_kern["bwd_wide"],
        "route_kernels": {
            "wgmma": "bfloat16 up to hd 256: flash_bwd_dq_wgmma_pipe at hd "
                     "128, flash_bwd_dq_wgmma at 64, 192 and 256; "
                     "flash_bwd_dkdv_wgmma_pipe at 64 and 128 with G > 1, "
                     "flash_bwd_dkdv_wgmma with G = 1, "
                     "flash_bwd_dkdv_wgmma_split at 192 and 256",
            "wgmma_chunked": "flash_bwd_dq_wgmma_cols + "
                             "flash_bwd_dkdv_wgmma_cols, bfloat16 above hd "
                             "256",
            "tf32x3": "flash_bwd_dq_tf32x3 + flash_bwd_dkdv_tf32x3, "
                      "float32 as three TF32 products"},
        "autograd_cols_err": train_kern["bwd_autograd_cols"],
        "entry_2_31_s": train_kern["bwd_entry_s"],
        **{key: {k: train_kern[arch][k] for k in (
            "shape", "bwd_ms", "bwd_plain_ms", "bwd_bound_ms", "bwd_err",
            "sdpa_fwd_bwd_ms", "fwd_bwd_ms", "bwd_registers")}
           for key, arch in (("qwen", "qwen1.5-110b"),
                             ("nemotron", NEMOTRON_ARCH))},
        "nemotron_step": {k: nemotron[k] for k in (
            "launches_per_step", "counts", "bwd_device_ms_per_launch",
            "step_s", "grad_err", "loss_rel", "peak_gb")},
        "encdec_train_launches_per_step":
            encdec_train["launches_per_step"]["flash_bwd"],
        "vlm_train_launches_per_step":
            vlm_train["launches_per_step"]["flash_bwd"],
        **{key: {k: train_kern[arch][k] for k in (
            "shape", "bwd_ms", "bwd_plain_ms", "bwd_bound_ms", "bwd_err",
            "sdpa_fwd_bwd_ms", "fwd_bwd_ms", "fwd_lse_ms", "fwd_ms")}
           for key, arch in (("whisper", ENCDEC_ARCH),
                             ("internvl2", VLM_ARCH))},
        "hgmma_in_sass": hgmma[FA.BWD_SOURCE.name]})
    # bf16 at hd 64 and 128: the two-warpgroup pair on the route and its
    # yardstick; their main path internvl2-1b's training step (G = 7: dq on
    # flash_bwd_dq_wgmma<64>, dk/dv on flash_bwd_dkdv_wgmma_pipe<64>) at
    # its shape: ms by events over each launch alone, device_ms and
    # library_ms (SDPA's backward alone, null where the profiler recorded
    # none) by the profiler
    pipe = train_kern["bwd_pipe"]
    iv = pipe[VLM_ARCH]
    common = {"source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
              "replaces": "src/repro/models/layers.py:201",
              "plain_ms": iv["plain_ms"], "bound_ms": iv["bound_ms"],
              "bound_by": iv["bound_by"], "shape": iv["shape"],
              # SDPA's backward alone (cuDNN), timed only
              "library_ms": iv["sdpa_bwd_ms"],
              "library_wall_ms": iv["sdpa_bwd_wall_ms"],
              "sdpa_fwd_bwd_ms": iv["sdpa_fwd_bwd_ms"]}
    # the training steps' profiles: launches of each backward kernel a step
    step_launches = {
        arch: {k: r["profile"]["bwd_kernels"][k]["launches"]
               for k in r["profile"]["bwd_kernels"]
               if k.startswith("flash_bwd_")}
        for arch, r in ((TRAIN_ARCH, train), (MOE_ARCH, moe_train),
                        (ENCDEC_ARCH, encdec_train), (VLM_ARCH, vlm_train))}
    yard_names = {f"flash_bwd_{p}_wgmma<{w}>" for p in ("dq", "dkdv")
                  for w in (64, 128)}
    kernels.append({
        "name": "flash_attention_bwd_hd64_128", "route": "cuda", **common,
        "kernels": "dq: flash_bwd_dq_wgmma_pipe<128>, flash_bwd_dq_wgmma<64>; "
                   "dk/dv: flash_bwd_dkdv_wgmma_pipe<64|128> (G > 1), "
                   "flash_bwd_dkdv_wgmma<64|128> (G = 1)",
        "launches": vlm_train["counts"]["flash_bwd"],
        "launches_per_step": vlm_train["launches_per_step"]["flash_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in pipe.values()),
        "ms": iv["ms"], "launch_ms": iv["launch_ms"],
        "device_ms": iv["device_ms"],
        "fwd_bwd_ms": iv["fwd_bwd_ms"], "wall_ms": iv["wall_ms"],
        "registers": bwd_pipe_regs, "step_launches": step_launches,
        "step_device_ms": {
            VLM_ARCH: vlm_train["profile"]["bwd_kernels"],
            TRAIN_ARCH: train["profile"]["bwd_kernels"]},
        "step_flash_bwd_ms": {
            VLM_ARCH: vlm_train["profile"]["flash_bwd_ms"],
            TRAIN_ARCH: train["profile"]["flash_bwd_ms"]},
        "shapes": pipe})
    kernels.append({
        "name": "flash_attention_bwd_hd64_128_yardstick", "route": "cuda",
        **common,
        "kernels": "flash_bwd_dq_wgmma<64|128> + flash_bwd_dkdv_wgmma<64|128> "
                   "through flash_bwd_dq_bf16_yardstick and "
                   "flash_bwd_dkdv_bf16_yardstick",
        # its kernels' launches in the training steps' profiles, where the
        # route still runs them (dq at hd 64, dk/dv at G = 1); the C
        # functions themselves are no route's
        "launches": sum(n for d in step_launches.values()
                        for k, n in d.items() if k in yard_names),
        "max_abs_err": max(r["yardstick_abs_err"] for r in pipe.values()),
        "ms": iv["yardstick_ms"], "launch_ms": iv["yardstick_launch_ms"],
        "device_ms": iv["yardstick_device_ms"]})
    serve_line = {k: served[k] for k in ("prefill_ms", "decode_ms", "tok_s",
                                         "peak_gb", "base_gb", "logit_err")}
    serve_line["fp32_logit_err"] = fp32_err
    serve_line["fp32_flash_routes"] = fp32_routes
    serve_line["profile"] = serve_prof
    train_line = {k: v for k, v in train.items() if k != "counts"}
    moe_serve_line = {k: moe_served[k] for k in (
        "n_params", "n_active", "prefill_ms", "decode_ms", "decode_bound_ms",
        "tok_s", "peak_gb", "base_gb", "logit_err", "logit_err_alone",
        "drops", "oracle", "profile")}
    moe_train_line = {k: v for k, v in moe_train.items() if k != "counts"}
    family_keys = ("n_params", "n_active", "cuts", "prefill_ms", "decode_ms",
                   "decode_bound_ms", "tok_s", "peak_gb", "base_gb",
                   "logit_err", "logit_err_alone", "drops", "route_flips",
                   "fp32_logit_err", "rmsnorm_err", "profile")
    print(json.dumps({"s_per_version": per_version,
                      "wire_bytes": wire_bytes, "serve": serve_line,
                      "gateway": gw, "train": train_line,
                      "train_nemotron": nemotron,
                      "serve_moe": moe_serve_line,
                      "serve_ssm": {k: ssm_served[k] for k in family_keys},
                      "serve_hybrid": {k: hybrid_served[k]
                                       for k in family_keys},
                      "train_moe": moe_train_line,
                      "serve_encdec": {k: v for k, v in encdec_served.items()
                                       if k != "kernels"},
                      "serve_vlm": {k: v for k, v in vlm_served.items()
                                    if k != "kernels"},
                      "train_encdec": {k: v for k, v in encdec_train.items()
                                       if k != "counts"},
                      "train_ssm": {k: v for k, v in ssm_train.items()
                                    if k not in ("counts", "profile")},
                      "analysis": analysis, "mesh": mesh,
                      "train_vlm": {k: v for k, v in vlm_train.items()
                                    if k != "counts"}}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
