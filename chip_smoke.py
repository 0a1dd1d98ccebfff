#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:   python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi) and torch's version;
  2. the nvcc build of src/repro_torch/csrc/*.cu, with its seconds; then
     the kernels PyTorch's ``scaled_dot_product_attention`` runs at the
     model's prefill shape in bf16 and fp32, by the profiler, before any
     other trace;
  3. each CUDA kernel against its plain PyTorch version on the card, at the
     main path's shapes (512 frames of 64x64), timed with CUDA events beside
     the least time the card could take (bytes over 3.35 TB/s);
  4. one RAAR step at paper size with the kernels against the plain path;
  5. the §III stream at the paper's Table II size (512 frames, 256x256
     object, 64x64 probe, scan step 8) through ``run_stream``, with its
     quality, the kernels' launch counts, the sink's contents and its
     artifact lane's report (every batch delivered, none failed) checked;
     with ``--obs-port 0``: the endpoint's ``/metrics.json`` and
     ``/traces`` read over HTTP before ``close()``, one span per committed
     batch, ``stream_records_total`` 512, and each stage's total time and
     share of the spans' total printed;
  6. a profile of RAAR steps at 512 frames: device time by kernel;
  7. the ART kernel over the system's non-zeros (CSR) against its plain
     dense PyTorch version on the card, at the shapes of
     tests/test_kernels.py, at (24, 37), at a dense (8, 1,000) whose rows
     are longer than a warp holds in registers, and at the §IV path's full
     shape (the (19,456 x 65,536) system
     of nray 256 and 76 angles, 8 slices and one sweep, and a stream
     launch's 16 slices and two sweeps), each also against the plain
     version in float64, timed beside its bound and the dense sweep's
     bound; then a launch's time at 16, 128 and 256 slices;
  8. the §IV tomography stream at full width (256 slices of 256x256, 76
     angles, 2 sweeps, 4 partitions) through ``run_stream``, its
     partitions on the stream's ``TaskScheduler`` (4 executor threads,
     speculation on), with its residual and volume error held to the JAX
     reference's, the ART launches against the partitions processed (and
     the speculative copies, if any), and the sink's keys, with
     ``--obs-port 0`` read back as in phase 5 (``stream_records_total``
     256); then a profile of one of its batches: device time and idle
     share;
  9. ptxas's registers, shared memory and spills of the ART kernel and
     the two tensor-core flash kernels (each instance, hd 64, 128 and
     256), the HGMMA count of each wgmma instance's SASS and the TF32 HMMA
     count of the tf32x3 kernel's at hd 64, 128 and 256; then the three
     flash-attention kernels against their plain version on the card: at
     the shapes of tests/test_kernels.py the tf32x3 kernel (fp32) and the
     SIMT kernel (bf16); at hd 64, 128 and 256 the tf32x3 kernel (every
     fp32 call) and the wgmma kernel (every bf16 call) at S 64 and 130
     (one tile, a ragged last one), 1,000 through ``ops`` and the prefill
     shape (B 4, S 1,024, H 16: internlm2-1.8b's at hd 128, gemma-7b's at
     hd 256, B·H 64 at hd 64), each timed there beside its bound and
     PyTorch's ``scaled_dot_product_attention`` (timed for the table
     only), and at hd 64 granite-moe-3b-a800m's prefill shape (H 24); the
     SIMT kernel timed at the model's batch and sequence in bf16 at hd 32;
 10. internlm2-1.8b at full width on the card from the seed: a 4 x 1,024
     prompt batch prefilled with the kernel (every launch on the wgmma
     kernel) and with the naive attention, logits and greedy tokens
     compared; then the serve invariant (greedy prefill + decode equals the
     argmax of teacher-forced prefills) in fp32, B 2, S 256, 4 tokens, with
     the kernel on (every launch on the tf32x3 kernel);
 11. the serve stream at full width through ``run_serve``: 16 requests of
     1,024 tokens in batches of 4, 32 tokens out each, in bf16, its
     flash launches counted (4 batches x 24 layers, all on the wgmma
     kernel); then one batch: its
     tokens against the model's own prefill/decode_step loop, the same loop
     with the naive attention (reported: the first differing token of each
     request and the top-2 logit gap there), and a profile: device time by
     kernel and idle share;
 12. the §III restart at Table II size through ``run_restart``: frame ids
     into a durable log, a spawned consumer running windowed RAAR (windows
     of 64 frames, 6 steps each) SIGKILLed mid-window, the resumed run
     in-process; the window set held exactly (8 windows of 64 frames), each
     window's Fourier error held to an uncrashed run of the same window on
     the card (1e-5 relative), the resumed run's launches to the windows it
     fired x 6, and the kill offset, the windows on disk at the crash and
     the produce, reopen and resume times printed beside the card's name
     and power limit;
 13. the remote ingest at the §III frame shape through
     ``run_remote_ingest`` (``--frames 512 --obj-size 448 --probe-size
     64``: 512 of a 625-position scan of 64x64 fp32 frames), once over TCP
     and once over a Unix socket: a spawned detector process on the host
     pumps the frames through ``IngestRunner`` and ``RemoteBroker`` to a
     ``BrokerServer`` here, whose micro-batches go to the card; every frame
     consumed once, none rejected, every produce on a shared-memory frame,
     the producer's lag within its bound, the photon count and peak
     computed on the card held to numpy's over the same frames (1e-5
     relative), and no shared-memory segment left;
 14. (run right after phase 8, while its system is still on the card) a
     §IV consumer-group handoff at full width: phase 8's 256 sinogram rows
     keyed by slice index on a 4-partition topic, two streaming contexts in
     threads of one process in group "tomo" (heartbeat 0.05 s, session
     timeout 0.4 s), each range of a batch reconstructed by the ART kernel
     into a sink keyed by slice; one consumer goes silent after its second
     committed batch, the survivor takes its partitions over, and the
     silent one's late commit is fenced; every slice in the sink, group lag
     0, the volume held to phase 8's slice by slice (1e-6 relative) and to
     the JAX reference's residual and error (1e-3), ART launches only, one
     a range; the handoff gap, the slices processed twice, the generations
     and the stream time printed;
 15. broker HA under the card's consumer through ``run_ha_failover``
     (``--frames 512 --obj-size 448 --probe-size 64``, 2 partitions):
     a durable primary in its own process, its
     follower as the standby, a spawned producer through a
     ``FailoverBroker``, the primary SIGKILLed after frame 256, a consumer
     on its own ``FailoverBroker`` reducing each batch on the card; every
     frame id in the sink, every frame read back from the promoted broker
     equal to the producer's (CRC-32), photons and peak over the
     deduplicated frames held to numpy's over the frames read back (1e-6
     relative), both clients at one failover or more and epoch 1, the
     restarted zombie fenced, no shared-memory segment left, no kernel
     launched; the time from the kill to the next frame produced, the
     resend window's duplicates, the cursors rewound and frames/s printed;
 16. the Spark-MPI bridge (``TorchBridge``): in this process over an NCCL
     group of world 1 (from a ``FileStore``), the quickstart's two
     reductions at 2,000,000 floats (``buffer[-1]`` 5.0 on both paths, the
     buffers equal), sum, max and mean exact against numpy and int8 within
     0.05, each timed with CUDA events; then two spawned processes on the
     card over gloo with CUDA tensors: the all-reduces against numpy, and
     6 RAAR steps at 512 frames, each rank holding half the frames and
     passing ``group=``, held to the one-process chain on the same frames
     (1e-5 relative, L2), each rank's modulus, overlap and raar launches
     counted;
 17. the §III stream with ``--elastic`` at Table II size (512 frames,
     batches of 64, 6 steps a batch, 60 refinement steps, 4 worker slots
     on the card): every frame consumed, the §III limits, one policy
     observation a batch, the world within [1, 4], each scale event's
     bridge handed to the pipeline, the peak lag within the runner's
     bound; records shed, scale events, the stream and total times and the
     kernels' launches printed;
 18. ``run_with_recovery`` over 12 RAAR steps at 512 frames on 4 worker
     slots of the card, a checkpoint every 4 steps (``save`` and
     ``restore(device=card)``), one worker failed before step 6: steps 4-5
     re-run at world 3, the restored state bit-equal to the saved one, the
     final object within 1e-5 (relative, L2) of an uncrashed run; then the
     ``AsyncCheckpointer`` with keep 2; save and restore times and bytes
     printed.
 19. the dense configs at full width from the seed, each drawn in bf16
     and released before the next: gemma-7b (hd 256), minitron-8b and
     starcoder2-3b, each with its parameter count, a 4 x 1,024 prompt
     batch prefilled with the kernel (one wgmma launch a layer) and with
     the naive attention, last-token logits compared, both timed; then its
     serve stream through ``run_serve`` (gemma-7b 8 requests of 1,024
     tokens in batches of 4, 16 tokens out; the others one batch of 4, 8
     tokens out), every flash launch on the wgmma kernel, with tokens/s,
     per-batch prefill and decode and the time to first token; for
     gemma-7b also the serve invariant in fp32 (B 2, S 256, 4 tokens, every
     launch on the tf32x3 kernel at hd 256) on fp32 parameters drawn after
     the bf16 ones left the card; where a prefill's and 7 decode steps'
     device time goes (flash, GEMMs, the rest, by the profiler); each
     model's time and peak device memory.
 20. the MoE family: granite-moe-3b-a800m at full width (32 layers, 24/8
     heads of hd 64, 40 experts of 512, top 8) drawn in bf16 from the
     seed: a 4 x 1,024 prompt batch prefilled with the kernel (one wgmma
     launch a layer at hd 64) and with the naive attention, both timed;
     each layer's attention output held, kernel against naive on that
     layer's input from the naive run, within the bf16 FLASH_TOL; the
     last-token logits' difference and the share of routing decisions that
     differ between the two runs reported, not held (top-k routing is
     discontinuous: see ``moe_prefill_check``); the serve stream through
     ``run_serve`` at the published capacity factor (8 requests of 1,024
     tokens in batches of 4, 16 out; every flash launch on the wgmma kernel
     at hd 64); the prefill's and 7 decode steps' device time (flash,
     GEMMs, the MoE dispatch, the rest); the fp32 serve invariant (B 2, S
     256, 4 tokens, capacity factor 5.0, drop-free; every launch on the
     tf32x3 kernel at hd 64); the peak device memory.
 21. (run right after phase 14, while phase 8's system is still on the
     card) the §IV stream at full width through ``run_stream`` on a
     ``TaskScheduler`` of 4 executors with speculation, as
     ``examples/tomo_pipeline.py`` runs it: (a) clean, (b) with a
     ``FailureInjector`` losing the first attempts at partitions 0 (the
     first batch's broker read, replayed from its offsets) and 1 (an ART
     partition) and making partition 2 a 1.5 s straggler in every batch;
     each volume held to phase 8's slice by slice (1e-6 relative) and to
     the JAX reference's residual and error (1e-3), the ART launches, read
     once the abandoned attempts' threads ended, to the partitions' results
     plus one a speculative copy, (b)'s retries >= 2, speculative copies >=
     4 and their wins >= 4; stream and batch times beside phase 8's;
 22. recurrentgemma-2b at full width (26 layers, 2,560 wide, 10/1 heads of
     hd 256, window 2,048, RG-LRU width 2,560, vocabulary 256,000) drawn
     from the seed in bf16: (a) 8 requests of 2,560 tokens in batches of 4,
     16 tokens out, through ``run_serve``: no kernel launched (the
     windowed prefill runs the blocked schedule, the reference's branch),
     per-batch prefill and decode-step times, time to first token,
     tokens/s, peak memory, and the first batch's tokens equal to the
     model's own loop; (c) a profiled prefill of that batch split into
     GEMMs, the blocked attention, the RG-LRU scan, the causal conv and the
     rest, with its idle share; (b)
     the fp32 serve invariant (B 2, a 2,560-token prompt, 8 tokens, every
     decode step past the window) on fp32 parameters.
 23. whisper-medium at full width (24 encoder and 24 decoder layers, 1,024
     wide, 16/16 heads of hd 64, vocabulary 51,865, 1,500 frames, learned
     positions; 793,101,312 parameters) drawn from the seed in bf16: the
     first served batch's requests (4 prompts of 384 tokens, each with its
     fp32 frames) prefilled with the kernel and with the naive attention,
     last-token logits within MAX_PREFILL_LOGIT_DIFF, the attention calls,
     their flash launches and their blocked calls counted by kind (24
     decoder self-attention calls, one wgmma launch each at hd 64; the 24
     encoder calls on the blocked schedule, the 24 cross calls naive, no
     launch); the serve stream through ``run_serve`` (one
     batch of 4 requests, 64 tokens out; every flash launch on the wgmma
     kernel) with tokens/s, prefill and decode times and the time to first
     token, the batch equal to the model's own loop over the same frames; a
     profiled prefill split by attention call (encoder, cross, decoder with
     flash), GEMMs and the rest, with its idle share; the fp32 serve
     invariant (B 2, 384 tokens, 8 tokens out, 216 launches on the tf32x3
     kernel at hd 64); peak device memory.
 24. rwkv6-7b at full width (32 layers, 4,096 wide, 64 heads of 64, d_ff
     14,336, vocabulary 65,536; 7,534,944,256 parameters) drawn from the
     seed in bf16: the serve stream through ``run_serve`` (one batch of 4
     requests of 1,024 tokens, 16 out) with no kernel launched (the
     reference has no Pallas WKV), tokens/s, prefill and decode-step
     times, the batch equal to the model's own loop; on the last layer's
     own r, k, v and
     log w from a prefill, the chunked WKV against the recurrent one
     within 2e-4 of the largest magnitude, each one's distance from a
     float64 recurrence reported; a profiled prefill split into the WKV,
     GEMMs and the rest, with its idle share; the fp32 serve invariant (B
     2, a 256-token prompt, 8 tokens) on fp32 parameters; peak device
     memory.
 25. llava-next-34b at full width and full depth (60 layers, 7,168 wide,
     56/8 heads of hd 128, d_ff 20,480, vocabulary 64,000; 34,388,917,248
     parameters) drawn from the seed in bf16 on a card the earlier phases
     left empty (the memory allocated before the draw printed): the first
     served batch's requests (4 prompts of 1,024 tokens, each behind its
     576 fp32 image embeddings) prefilled with the kernel (one wgmma
     launch a layer at hd 128), timed; at B 1 over the same 1,600
     positions the kernel's last-token logits within
     MAX_PREFILL_LOGIT_DIFF of the naive attention's; the serve stream
     through ``run_serve`` (8 requests in batches of 4, 16 tokens out,
     every request with its image embeddings; every flash launch on the
     wgmma kernel) with tokens/s, prefill and decode-step times, the time
     to first token and the peak device memory, the first batch equal to
     the model's own loop behind the same images; the fp32 serve invariant
     at a stated cut of 8 layers (5,380,365,312 parameters, 21.52 GB; the
     full depth in fp32 would need 137.6 GB), B 2, 576 + 256 positions, 8
     tokens, 72 launches on the tf32x3 kernel at hd 128.
 26. training: (a) each family's train step (internlm2-1.8b,
     granite-moe-3b-a800m at capacity factor E/k, rwkv6-7b,
     recurrentgemma-2b, whisper-medium, llava-next-34b) at reduced() in fp32
     on the card against the same step on the CPU, same weights and batches:
     the step-1 gradients within 1e-4 of each leaf's largest magnitude, 5
     losses within 1e-5 relative; (b) internlm2-1.8b at full width
     (1,889,110,016 parameters in bf16, fp32 master, m and v, remat full):
     the step-1 gradients finite and non-zero on every leaf; (b1) 12 steps
     of ``build_train_step`` overfitting one batch of 4 x 1,024 tokens (lr
     1e-3, warmup 2, total 40: tests/test_training.py's settings), the loss
     falling by 0.3 or more, every loss and gradient norm finite, no flash
     launch; a profiled step split into the blocked attention (the train
     step's schedule for ``flash``), the AdamW update, the other GEMMs and
     the rest, with its idle share; (b2) ``run_train`` on the stream (batch
     4, 1,024 tokens, 8 steps) with its step times, tokens/s,
     ``realtime_report`` and peak memory; (c) in a child process under
     deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` set),
     tests/test_training.py's bit-exact resume at reduced(): 10 steps
     straight against 5, a save, a restore and 5 more; (d) ``python -m
     repro_torch.launch.train --reduced`` with a checkpoint directory, then
     again with ``--resume``.
 27. the tiled schedules at full width: internlm2-1.8b (bf16 from the
     seed) on train_4k's 4,096-token sequences: (a) one prefill of 1 x
     4,096 tokens under ``flash`` (24 wgmma launches at hd 128),
     ``blocked``, ``blocked`` with ``_skip_blocks`` and ``triangular``,
     each timed, last-token logits within MAX_PREFILL_LOGIT_DIFF of
     ``naive``'s, and in fp32 on layer 0's own q, k and v each tiled
     schedule within 1e-5 of the naive attention; (b) ``build_train_step``
     on 4 x 4,096 tokens (train_4k's batch of 256 cut to 4 for one card) on
     the default schedule: 6 steps overfitting one batch with phase 26's
     optimizer, the loss falling by 0.3 or more, every loss and gradient
     norm finite; step time, tokens/s, peak memory, and a profiled step
     split into the blocked attention, AdamW, the other GEMMs and the rest
     with its idle share; (c) the same from the same state with
     ``_skip_blocks``, then ``triangular``, 2 steps each (3 until phase
     31): step 1's loss
     within 1e-3 relative of (b)'s; step times, peak memory, tiles issued.
 28. the explicit-collective data-parallel trainer (``parallel/dp.py``) in
     a child process under deterministic algorithms: (a) NCCL at world 1,
     internlm2-1.8b at full width on 4 x 1,024 tokens with
     tests/test_dp.py's optimizer, 4 steps of ``build_dp_train_step``
     against 4 of ``build_train_step`` from the same state, then with
     int8 against a plain int8 step written apart from the module, each
     within tests/test_dp.py's bounds (losses 1e-2, parameters rtol 2e-2
     and atol 2e-3); step times split into gradients, collectives and the
     rest, peak memory; (b) two spawned gloo processes on the card at a
     depth cut of 2 layers, 2 rows each, without and with int8, 2 steps
     each (4 until phase 31 took the time), held to the one-process step
     and the plain int8 step over the same rows.
 29. the mesh in a child process under deterministic algorithms:
     internlm2-1.8b's ``shardings_for`` train and prefill cells on a
     (data 1, model 1) mesh at NCCL world 1 at full width, then ZeRO-1 and
     tensor-parallel meshes of two host-staged gloo processes at 2 layers
     on 4 x 256 tokens (4 x 1,024 until phase 31 took the time); (a)'s
     decode 2 steps (8 until phase 31).
 30. the all-to-all MoE and the pipeline in a child process under
     deterministic algorithms: (a) granite-moe-3b-a800m at full width with
     the a2a overrides at NCCL world 1 on a (data 1, model 1) mesh, the
     reference's fallback, its bf16 prefill bit-equal to the unpadded
     scatter run's with 32 wgmma launches; (b) two host-staged gloo
     processes on (data 2, model 1), each owning 20 of the 40 experts a
     layer at full width and depth: the bf16 prefill of 4 x 1,024 (32
     wgmma launches a rank) and 2 decode steps (8 until phase 31), the
     fp32 prefill of 4 x 128 (4 x 512 until phase 31) at
     capacity factor 5.0 with every layer's a2a output held to
     ``moe_layer`` on its own input (rtol/atol 2e-3, aux 1e-5), and a
     train step at 2 layers whose gradients are held to the one-process
     scatter step's (1e-4 of each leaf's largest magnitude); (c)
     internlm2-1.8b's 24 blocks in fp32 over 2 pipeline stages of gloo
     processes, forward (2e-5) and the gradients of sum(y^2) (2e-4)
     against the blocks in sequence; times, the host-staged collectives'
     share and peak memory throughout.
 31. the dry-run (``launch/dryrun.py``, its walker ``launch/opcost.py``,
     ``training.lower_cell``): (a) in a process of its own, started after
     phase 1 (its traces are host work alone, ~90 s, which the phases
     before this one overlap) and waited for here, ``run_cell`` with
     ``device="cuda"``: internlm2-1.8b's train_4k, prefill_32k and
     decode_32k on the (16, 16) production mesh and its train_4k on (2,
     16, 16), each traced on fake CUDA tensors under a fake process group
     of 256 or 512, every record ok, a card's flops, bytes, NVLink and
     network bytes, peak, dominant term and useful share printed, the
     prefill cell tracing exactly one flash operator call a layer; (b)
     phase 29 (a)'s train and prefill cells (4 x 1,024 tokens) and a
     decode step over decode_32k's 32,768 cached positions at 4 rows (its
     128 cut for one card) traced with ``lower_cell`` on a (data 1, model
     1) mesh under a fake group of one, then run under NCCL at world 1
     once under the walker and twice timed: the real run's flops and bytes
     equal to the trace's, the traced peak within 10 % of the allocator's,
     no timed step under the roofline's largest term / 1.05, the prefill's
     traced flash calls equal to its wgmma launches at hd 128; each
     cell's roofline share of its median step printed; (b) runs in a
     child process, as a fake process group and a real one may each be
     the default group only in turn.
Each phase prints its own wall time when it ends. It then prints a JSON
line of the kernels (the ART row's
``launches_group_handoff`` is phase 14's count, ``launches_scheduler`` and
``launches_scheduler_faults`` phase 21's; the modulus, overlap and
raar rows carry ``launches_group_ranks``, ``launches_elastic_stream`` and
``launches_recovery``, phases 16-18's; the flash rows at hd 256 carry
phase 19's counts, gemma-7b's serve stream as ``launches`` and its fp32
invariant as ``launches_fp32_invariant``, and the wgmma row at hd 128
``launches_dense_configs``, minitron-8b's and starcoder2-3b's served
batches; the flash rows at hd 64 carry phase 20's, its serve stream as
``launches`` and its fp32 invariant as ``launches_fp32_invariant``, and
phase 23's as ``launches_audio`` and ``launches_audio_fp32_invariant``;
the flash rows up to hd 128 carry phase 25's serve stream as
``launches_vlm``, its fp32 invariant as ``launches_vlm_fp32_invariant``,
phase 26's training runs as ``launches_train``, 0, and phase 27's flash
prefill as ``launches_schedules``; every flash row carries phase 29's
``launches_mesh`` and ``launches_mesh_gloo_tp`` and phase 30's
``launches_moe_a2a`` ((a)), ``launches_moe_a2a_gloo`` ((b)'s bf16
prefills over both ranks) and ``launches_moe_a2a_gloo_fp32``; every
flash row carries phase 9's own launches of its instances as
``launches_kernel_checks``, and phase 31's real prefill as
``launches_dryrun``; phase 9's timed rows also carry ``direct_ms``, the
same launch without the operator's dispatch), the nvidia-smi line again,
and as its last line {"ok": true, "device": {...}}. Without a GPU, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build" / "chip_smoke"
SEED = 0
F, H, W = 512, 64, 64               # the main path's largest batch
PAPER_ARGS = ["--frames", "512", "--obj-size", "256", "--probe-size", "64",
              "--scan-step", "8"]
RESTART_ARGS = PAPER_ARGS + ["--restart", "--batch-frames", "64",
                             "--iters-per-batch", "6"]
RESTART_WINDOWS, RESTART_WINDOW, RESTART_ITERS = 8, 64, 6
RESTART_RTOL = 1e-5
REMOTE_ARGS = ["--frames", "512", "--obj-size", "448", "--probe-size", "64"]
REMOTE_FRAMES, REMOTE_RTOL = 512, 1e-5
# H100 SXM (NVIDIA data sheet): device memory rate, the fp32 rate outside
# the tensor cores, the dense bf16 and TF32 rates of the tensor cores, and
# the L2's size
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
TF32_TC_OPS_PER_S = 495e12
L2_BYTES = 50 * 2**20
MAX_FINAL_ERROR = 0.10              # the JAX reference reaches 0.0865 here
MIN_QUALITY = 0.92                  # ... and 0.943
OWN_KERNELS = ("modulus_project_kernel", "overlap_products_kernel",
               "raar_combine_kernel")
ART_KERNEL = "art_csr_kernel"
FLASH_KERNELS = ("flash_attention_kernel", "flash_attention_wgmma_kernel",
                 "flash_attention_tf32x3_kernel")
GEMM_MARKERS = ("gemm", "nvjet", "xmma", "cutlass")    # cuBLAS's kernels
ART_SHAPES = ((8, 16), (20, 12), (32, 64))      # tests/test_kernels.py:93
ART_ODD_SHAPE = (24, 37)        # kept from the dense kernel's checks
# rows of 1,000 non-zeros: past the 32 x 24 pairs a warp holds in
# registers, so the kernel's tail loop runs
ART_LONG_SHAPE = (8, 1000)
ART_TOL = dict(rtol=1e-4, atol=1e-4)            # tests/test_kernels.py:107
# the dense plain sweep at the full shape (2.4-5.7 s a call) is timed
# once, after the check's call warmed it: 3 times after a warm-up until
# phase 31 took the time
ART_FULL_PLAIN_REPS = 1
NRAY, NANGLES, NSLICE, PARTITIONS = 256, 76, 256, 4
TOMO_ARGS = ["--nray", str(NRAY), "--angles", str(NANGLES), "--nslice",
             str(NSLICE), "--iterations", "2", "--partitions",
             str(PARTITIONS)]
# The JAX reference at TOMO_ARGS: repro.apps.tomo.solver.reconstruct_slices
# (use_pallas=False) on the CPU, printed by tools/tomo_reference_slices.py.
# Sinogram residual |A f - b|/|b| and volume error |f - v|/|v| of the whole
# volume, and of each of slices 124-131.
REF_RESIDUAL, REF_ERROR = 0.4772438704967499, 0.6329998150856019
REF_SLICES = range(124, 132)
REF_SLICE_RESIDUAL = (0.5196922074787964, 0.5103182872600535,
                      0.5006286466844522, 0.4907017190604099,
                      0.4806879313024302, 0.47043846739413936,
                      0.460561056291703, 0.45032384930051644)
REF_SLICE_ERROR = (0.6561629934299793, 0.6542791921408858,
                   0.652562630357193, 0.6505630711609283,
                   0.6492461233015283, 0.6465218432424262,
                   0.642746150133384, 0.6372793810563379)
REF_TOL = 1e-3
FLASH_SHAPES = ((64, 16), (128, 32), (32, 8))    # tests/test_kernels.py:124
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:136
TC_HEAD_DIMS = (64, 128, 256)   # the tensor-core kernels' instances
# the flash rows of the kernels line, (design, the head dims whose launches
# the row counts) -> name: one row a design up to hd 128 but hd 64, as
# before, and one row each tensor-core instance at hd 256 (gemma-7b) and
# at hd 64 (granite-moe-3b-a800m, whisper-medium's decoder); together they
# cover every built
# (design, hd) instance of the wrapper
FLASH_ROWS = {("wgmma", (128,)): "wgmma, bf16 hd 128",
              ("tf32x3", (8, 16, 32, 128)): "tf32x3, fp32",
              ("simt", (8, 16, 32)): "simt, bf16 hd 8/16/32 only",
              ("wgmma", (256,)): "wgmma, bf16 hd 256",
              ("tf32x3", (256,)): "tf32x3, fp32 hd 256",
              ("wgmma", (64,)): "wgmma, bf16 hd 64",
              ("tf32x3", (64,)): "tf32x3, fp32 hd 64"}
MODEL_B, MODEL_S, MODEL_H, MODEL_HD = 4, 1024, 16, 128
ARCH = "internlm2-1.8b"
# bf16 prefill of the 4 x 1,024 batch, kernel against naive attention: the
# largest last-token logit difference allowed (see PERF.md, §6)
MAX_PREFILL_LOGIT_DIFF = 0.25
SERVE_ARGS = ["--requests", "16", "--batch", "4", "--prompt-len", "1024",
              "--gen", "32", "--seed", str(SEED)]
# phase 19: the other dense configs, each served at full width
DENSE_ARCHS = ("gemma-7b", "minitron-8b", "starcoder2-3b")
DENSE_SERVE_ARGS = {
    "gemma-7b": ["--requests", "8", "--batch", "4", "--prompt-len", "1024",
                 "--gen", "16", "--seed", str(SEED)],
    "minitron-8b": ["--requests", "4", "--batch", "4", "--prompt-len",
                    "1024", "--gen", "8", "--seed", str(SEED)],
    "starcoder2-3b": ["--requests", "4", "--batch", "4", "--prompt-len",
                      "1024", "--gen", "8", "--seed", str(SEED)],
}
# phase 20: the MoE family, granite-moe-3b-a800m served at full width
MOE_ARCH = "granite-moe-3b-a800m"
MOE_H = 24                          # its query heads, at hd 64
MOE_SERVE_ARGS = ["--arch", MOE_ARCH, "--requests", "8", "--batch", "4",
                  "--prompt-len", "1024", "--gen", "16", "--seed", str(SEED)]
# PyTorch's kernels of the MoE dispatch: the sorts, searchsorted, the
# scatter into the capacity buffer and the gathers out of it
DISPATCH_MARKERS = ("sort", "searchsorted", "index", "scatter", "gather")


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int = 25, warmup: int = 3,
             flush=None) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call.
    ``flush`` runs before each call, outside the events, to empty the L2."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _bound_ms(nbytes: float, ops: float,
              ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max_err(torch, got, want) -> float:
    return float((got - want).abs().max())


def _device_us(torch, prof) -> dict:
    """Device time in µs by kernel name over a profiled run (not counting
    the profiler's own step annotations, which it also puts on the device's
    timeline)."""
    kernels = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.name.startswith("ProfilerStep")):
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.device_time_total)
    return kernels


def _without_launches(variants: list[dict]) -> list[dict]:
    """Per-variant rows; launches are counted per kernel, not per variant."""
    return [{k: v for k, v in row.items() if k != "launches"}
            for row in variants]


def kernel_phase(torch, dev, flush) -> list[dict]:
    import numpy as np

    from repro_torch.kernels.modulus import kernel as mk
    from repro_torch.kernels.modulus import ref as mr
    from repro_torch.kernels.overlap import kernel as ok
    from repro_torch.kernels.overlap import ref as orf
    from repro_torch.kernels.raar import kernel as rk
    from repro_torch.kernels.raar import ref as rr

    rng = np.random.default_rng(SEED)

    def cplx(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).to(dev)

    n = F * H * W
    check = dict(rtol=1e-6, atol=1e-6)
    rows = []

    def measure(name, source, replaces, call, plain, nbytes, ops, tol,
                extra=()):
        got, want = call(), plain()
        torch.cuda.synchronize()
        outs = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = 0.0
        for g, w in zip(*outs):
            torch.testing.assert_close(g, w, **tol)
            err = max(err, _max_err(torch, g, w))
        for g, w, t in extra:
            torch.testing.assert_close(g, w, **t)
        ms = _time_ms(torch, call, flush=flush)
        plain_ms = _time_ms(torch, plain, flush=flush)
        bound, by = _bound_ms(nbytes, ops)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": by, "library_ms": None}
        print(f"  {name:34s} max|err| {err:.3g}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by})  "
              f"library n/a")
        return row

    # modulus: 8 B far + 4 B mag in, 8 B out; 8 operations an element
    far = cplx(F, H, W)
    mag = torch.from_numpy(
        np.abs(rng.standard_normal((F, H, W))).astype(np.float32)).to(dev)
    rows.append(measure(
        "modulus_project", "src/repro_torch/csrc/modulus.cu",
        "src/repro/kernels/modulus/kernel.py:35",
        lambda: mk.modulus_project(far, mag),
        lambda: mr.modulus_project_ref(far, mag), n * 20, n * 8, check))

    # overlap: probe update (b per frame, 28 B) and object update (b the
    # shared probe, 20 B); 9 operations an element
    a, b, probe = cplx(F, H, W), cplx(F, H, W), cplx(H, W)
    variants = []
    for label, bb, nbytes in (("probe update", b, n * 28),
                              ("object update", probe, n * 20 + H * W * 8)):
        complex_form = (a * bb.conj(), (bb.abs() ** 2).expand(a.shape))
        got = ok.overlap_products(a, bb)
        extra = [(got[0], complex_form[0], dict(rtol=1e-5, atol=1e-5)),
                 (got[1], complex_form[1], dict(rtol=1e-5, atol=1e-5))]
        variants.append(measure(
            f"overlap_products ({label})",
            "src/repro_torch/csrc/overlap.cu",
            "src/repro/kernels/overlap/kernel.py:34",
            lambda bb=bb: ok.overlap_products(a, bb),
            lambda bb=bb: orf.overlap_products_ref(a, bb), nbytes, n * 9,
            check, extra))
    row = dict(variants[0], name="overlap_products",
               max_abs_err=max(v["max_abs_err"] for v in variants),
               variants=_without_launches(variants))
    rows.append(row)

    # raar: four 8 B inputs, one 8 B output; 12 operations an element
    psi, p1, p21, p2 = (cplx(F, H, W) for _ in range(4))
    variants = []
    for beta in (0.5, 0.75, 0.9):
        aliased = (rk.raar_combine(psi, p1, p21, p21, beta),
                   rr.raar_combine_ref(psi, p1, p21, p21, beta), check)
        variants.append(measure(
            f"raar_combine (beta {beta})", "src/repro_torch/csrc/raar.cu",
            "src/repro/kernels/raar/kernel.py:32",
            lambda beta=beta: rk.raar_combine(psi, p1, p21, p2, beta),
            lambda beta=beta: rr.raar_combine_ref(psi, p1, p21, p2, beta),
            n * 40, n * 12, check, [aliased]))
    row = dict(variants[1], name="raar_combine",
               max_abs_err=max(v["max_abs_err"] for v in variants),
               variants=_without_launches(variants))
    rows.append(row)
    return rows


def step_phase(torch, dev, problem) -> None:
    """One RAAR step at paper size, kernels against the plain path on the
    card, at iterations 0 (object only) and 5 (object and probe)."""
    from repro_torch.apps.ptycho.solver import (SolverConfig, init_waves,
                                                raar_step)
    mags = problem.magnitudes[:F]
    pos = torch.as_tensor(problem.positions[:F], device=dev)
    probe = problem.probe_true
    psi = init_waves(mags, probe)
    shape = tuple(problem.object_true.shape)
    plain, kern = SolverConfig(use_cuda_kernels=False), SolverConfig()
    for it in (0, 5):
        want = raar_step(psi, mags, pos, probe, shape, plain, it)
        got = raar_step(psi, mags, pos, probe, shape, kern, it)
        errs = []
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
            errs.append(_max_err(torch, g, w))
        ms = _time_ms(torch, lambda: raar_step(psi, mags, pos, probe, shape,
                                               kern, it), reps=10)
        plain_ms = _time_ms(torch, lambda: raar_step(
            psi, mags, pos, probe, shape, plain, it), reps=10)
        print(f"  raar_step iteration {it} at {F} frames: kernels vs plain "
              f"max|err| psi {errs[0]:.3g} obj {errs[1]:.3g} probe "
              f"{errs[2]:.3g} err {errs[3]:.3g} (tol 2e-4); step "
              f"{ms:.3f} ms with kernels, {plain_ms:.3f} ms plain")


def profile_phase(torch, dev, problem) -> None:
    """Device time by kernel over a few RAAR steps at 512 frames."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps.ptycho.solver import (SolverConfig, init_waves,
                                                raar_step)
    mags = problem.magnitudes[:F]
    pos = torch.as_tensor(problem.positions[:F], device=dev)
    probe = problem.probe_true
    psi = init_waves(mags, probe)
    shape, cfg, steps = tuple(problem.object_true.shape), SolverConfig(), 5

    def run():
        state = (psi, probe)
        for _ in range(steps):
            out = raar_step(state[0], mags, pos, state[1], shape, cfg, 5)
            state = (out[0], out[2])
        torch.cuda.synchronize()

    run()                                  # warm-up
    t0 = time.perf_counter()               # wall time without the profiler
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kernels = _device_us(torch, prof)
    busy_ms = sum(kernels.values()) / 1e3
    if busy_ms == 0:
        print("  profile: the profiler saw no device time (not measured)")
        return
    own_ms = sum(us for name, us in kernels.items()
                 if any(k in name for k in OWN_KERNELS)) / 1e3
    print(f"  {steps} raar_steps at {F} frames: wall {wall_ms:.3f} ms "
          f"unprofiled; device busy {busy_ms:.3f} ms (profiled), idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; the port's kernels "
          f"{own_ms / steps:.4f} ms/step")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3 / steps:9.4f} ms/step "
              f"{100 * us / 1e3 / busy_ms:5.1f}%  {name[:90]}")


def stream_phase(torch, dev) -> dict:
    from repro_torch import kernels
    from repro_torch.apps.ptycho.stream import parse_args, run_stream

    shutil.rmtree(OUT, ignore_errors=True)
    args = parse_args(PAPER_ARGS + ["--out", str(OUT), "--obs-port", "0"])
    kernels.reset_launch_counts()
    res = run_stream(args, device=dev)
    counts = kernels.launch_counts()
    steps = res["iterations"]
    expect = {"modulus_project": steps, "raar_combine": steps,
              # the probe update's second launch from iteration 2 on
              "overlap_products": 2 * steps - min(steps, 2),
              "art_sweep": 0, "flash_attention": 0}
    print(f"  steps {steps}, launches {counts}, expected {expect}")
    if counts != expect or res["launches"] != expect:
        raise AssertionError(f"launch counts {counts} (run_stream reports "
                             f"{res['launches']}) != expected {expect}")
    if not all(math.isfinite(e) for e in res["batch_errors"]):
        raise AssertionError(f"bad batch errors {res['batch_errors']}")
    if not res["final_error"] <= MAX_FINAL_ERROR:
        raise AssertionError(f"final Fourier error {res['final_error']} > "
                             f"{MAX_FINAL_ERROR}")
    if not res["quality"] >= MIN_QUALITY:
        raise AssertionError(f"phase correlation {res['quality']} < "
                             f"{MIN_QUALITY}")
    batches = len(res["batch_errors"])
    want_keys = [f"batch-{i:06d}" for i in range(batches)] + ["object-final"]
    if res["sink_keys"] != want_keys:
        raise AssertionError(f"sink holds {res['sink_keys']}, expected "
                             f"{want_keys}")
    lane = res["lanes"].get("NpzDirectorySink")
    if (lane is None or lane["delivered"] != batches or lane["failed"]
            or lane["depth"]):
        raise AssertionError(f"artifact lane report {res['lanes']}: expected "
                             f"{batches} delivered, 0 failed, 0 queued")
    print(f"  artifact lane: delivered {lane['delivered']}, failed "
          f"{lane['failed']}, retries {lane['retries']}, max depth "
          f"{lane['max_depth']}, mean latency "
          f"{lane.get('mean_latency_s', 0.0):.6f} s, mean write "
          f"{lane.get('mean_write_s', 0.0):.6f} s")
    obs_report(res, batches, F, STREAM_STAGES | {"delivery_submit"})
    in_batches = sum(res["batch_times"])
    print(f"  wall time: batches {in_batches:.3f} s (device work "
          f"included), rest of the stream {res['stream_time'] - in_batches:.3f}"
          f" s (pump, broker, sinks, the drain wait), refinement "
          f"{res['total_time'] - res['stream_time']:.3f} s")
    print(f"  stream OK: {batches} batches, batch times (s) "
          f"{[round(t, 4) for t in res['batch_times']]}, setup "
          f"{res['setup_time']:.3f} s, stream {res['stream_time']:.3f} s, "
          f"total {res['total_time']:.3f} s vs acquisition window "
          f"{res['acquisition_window']:.1f} s -> near-real-time "
          f"{res['near_real_time']}; final error {res['final_error']:.4f} "
          f"(<= {MAX_FINAL_ERROR}), quality {res['quality']:.4f} "
          f"(>= {MIN_QUALITY})")
    return counts


# the span stages of a stream without checkpoint or window state
STREAM_STAGES = {"pump", "batch_fn", "sinks", "broker_commit"}


def obs_report(res: dict, batches: int, records: int,
               stages: set[str]) -> None:
    """The stream's endpoint as ``run_stream`` read it over HTTP before
    ``close()``: one span per committed batch with epochs 1..batches, the
    stream counters, the stages; each stage's total and share printed."""
    scrape = res["obs"]
    if scrape is None:
        raise AssertionError("run_stream returned no observability scrape")
    spans = scrape["spans"]
    got = (len(spans), scrape["batches"], scrape["records"],
           sum(s["num_records"] for s in spans))
    print(f"  observability endpoint {scrape['url']}: {got[0]} spans "
          f"(epochs {scrape['epochs']}), stream_batches_total {got[1]:.0f}, "
          f"stream_records_total {got[2]:.0f}; read over HTTP and stopped in "
          f"{res['obs_scrape_s'] * 1e3:.2f} ms, outside the stream time")
    if got != (batches, batches, records, records):
        raise AssertionError(f"(spans, batches, records, span records) "
                             f"{got} != {(batches, batches, records, records)}")
    if [s["epoch"] for s in spans] != list(range(1, batches + 1)):
        raise AssertionError(f"span epochs {[s['epoch'] for s in spans]}")
    if set(scrape["stages"]) != stages:
        raise AssertionError(f"span stages {sorted(scrape['stages'])} != "
                             f"{sorted(stages)}")
    for name, st in scrape["stages"].items():
        print(f"    {name:16s} {st['seconds']:10.6f} s  "
              f"{100 * st['share']:6.2f} %")
    pump = scrape["stages"]["pump"]["seconds"]
    covered = scrape["span_total_s"] + pump
    print(f"  per batch (s): "
          f"{[round(s['total_s'] + s['stages']['pump'], 4) for s in spans]}"
          f"; the spans and their pumps cover {covered:.4f} s of the "
          f"stream's {res['stream_time']:.4f} s, the rest "
          f"{res['stream_time'] - covered:.4f} s (idle polls, the drain "
          f"wait, close)")


def _shm_leftovers() -> list[str]:
    prefix = f"reprotorchshm_{os.getpid()}_"
    return [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]


def remote_phase(torch, dev, smi: str) -> None:
    """The remote ingest at the §III frame shape, over TCP and over a Unix
    socket: a spawned detector process on the host, the consumer's
    reduction on the card, held to numpy over the same frames."""
    import tempfile

    import numpy as np

    from repro_torch.apps.ptycho.remote_ingest import (parse_args,
                                                       run_remote_ingest)
    from repro_torch.apps.ptycho.sim import simulate

    # the producer's frames: the same scan simulated on the host
    base = parse_args(REMOTE_ARGS)
    problem = simulate(base.obj_size, base.probe_size,
                       step=max(8, base.probe_size // 4), device="cpu")
    mags = problem.magnitudes_host[:REMOTE_FRAMES].astype(np.float64)
    want = {"photons": float((mags ** 2).sum()), "peak": float(mags.max())}
    print(f"  scan: {problem.num_frames} positions of {problem.frame_shape}"
          f" fp32; {REMOTE_FRAMES} frames, "
          f"{mags.size * 4 / 2**20:.1f} MiB, cross the socket", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for family, addr in (("tcp", "127.0.0.1:0"),
                             ("unix", os.path.join(tmp, "broker.sock"))):
            args = parse_args(REMOTE_ARGS + ["--addr", addr])
            res = run_remote_ingest(args, device=dev)
            prod, served, rt = res["producer"], res["server"], res["realtime"]
            errs = {k: abs(res[k] - v) / abs(v) for k, v in want.items()}
            leftovers = _shm_leftovers()
            print(f"  {family} {res['address']}: {res['frames']} of "
                  f"{res['appended']} frames consumed, the last after "
                  f"{res['consume_s']:.4f} s: "
                  f"{res['frames'] / res['consume_s']:.1f} frames/s "
                  f"({res['wall_s']:.4f} s to the producer's exit); "
                  f"{prod['produce_calls']} produce calls, "
                  f"{prod['produced'] / prod['produce_calls']:.1f} frames a "
                  f"round trip, {prod['shm_frames_sent']} on shm frames; "
                  f"blocked {prod['blocked_s']:.4f} s, max lag "
                  f"{prod['max_observed_lag']} (bound "
                  f"{args.max_pending + 16}); {rt['batches']} batches, mean "
                  f"processing {rt['mean_processing_s'] * 1e3:.3f} ms, max "
                  f"{rt['max_processing_s'] * 1e3:.3f} ms, keeps_up "
                  f"{rt['keeps_up']} against {res['batch_interval']} s; "
                  f"server: {served['requests_served']} requests, "
                  f"{served['frames_rejected']} rejected, "
                  f"{served['shm_frames']} shm frames, "
                  f"{served['shm_segments']} segments left, /dev/shm "
                  f"{leftovers}; photons {res['photons']:.6e} (numpy "
                  f"{want['photons']:.6e}), peak {res['peak']:.6f} (numpy "
                  f"{want['peak']:.6f}), rel. diff "
                  f"{max(errs.values()):.3g}", flush=True)
            if not (res["frames"] == res["appended"] == REMOTE_FRAMES
                    and res["frame_ids"] == list(range(REMOTE_FRAMES))):
                raise AssertionError(f"{family}: consumed {res['frames']} "
                                     f"of {res['appended']} appended")
            if served["frames_rejected"]:
                raise AssertionError(f"{family}: frames rejected {served}")
            if not (prod["shm_frames_sent"] == prod["produce_calls"]
                    == served["shm_frames"] > 0):
                raise AssertionError(f"{family}: not every produce rode an "
                                     f"shm frame: {prod}, {served}")
            if prod["max_observed_lag"] > args.max_pending + 16:
                raise AssertionError(f"{family}: lag {prod} over its bound")
            if not max(errs.values()) <= REMOTE_RTOL:
                raise AssertionError(f"{family}: card {res['photons']}, "
                                     f"{res['peak']} vs numpy {want}")
            if served["shm_segments"] or leftovers:
                raise AssertionError(f"{family}: shm left: {served}, "
                                     f"{leftovers}")
    print(f"  remote ingest OK on {smi}", flush=True)


def _csr_bound_ms(csr, nslice: int, iters: int) -> tuple[float, str]:
    """The bytes and operations these inputs need: the CSR's columns, values
    and row pointers (again every sweep once larger than the L2), b,
    inv_rip, f in and out; a dot and an axpy, 4 operations a non-zero, a
    slice and a sweep."""
    nrow, ncol = csr.shape
    nnz = csr.col.numel()
    csr_bytes = 8 * nnz + 8 * (nrow + 1)
    reads = iters if csr_bytes > L2_BYTES else 1
    return _bound_ms(reads * csr_bytes + 4 * (nslice * nrow + nrow
                                              + 2 * nslice * ncol),
                     4 * nnz * nslice * iters)


def _dense_bound_ms(nrow: int, ncol: int, nslice: int,
                    iters: int) -> tuple[float, str]:
    """The dense sweep's bound: A read once a sweep when it
    exceeds the L2, every element of it a dot and an axpy."""
    a_reads = iters if 4 * nrow * ncol > L2_BYTES else 1
    return _bound_ms(4 * (a_reads * nrow * ncol + nslice * nrow + nrow
                          + 2 * nslice * ncol),
                     4 * nrow * ncol * nslice * iters)


def art_phase(torch, dev, flush) -> dict:
    """The ART kernel over the system's non-zeros (CSR) against the plain
    dense version in float32 (held to ART_TOL) and in float64 (reported),
    timed beside its bound and the dense sweep's."""
    import numpy as np

    from repro_torch.apps.tomo.projector import make_system, project
    from repro_torch.apps.tomo.solver import make_phantom
    from repro_torch.kernels.art import kernel as ak
    from repro_torch.kernels.art import ops as ao
    from repro_torch.kernels.art import ref as ar

    def measure(label, A, b, f0, iters, reps, csr=None, plain_reps=3):
        nrow, ncol = A.shape
        nslice = b.shape[0]
        inv_rip = ao.inverse_row_norms(A)
        if csr is None:
            csr = ao.csr_rows(A)

        def call():
            return ak.art_sweep(csr, b, inv_rip, f0, 1.0, iters)

        def plain():
            return ar.art_sweep_ref(A, b, inv_rip, f0, 1.0, iters)

        want = plain()
        want64 = ar.art_sweep_ref(A.double(), b.double(), inv_rip.double(),
                                  f0.double(), 1.0, iters)
        got = call()
        torch.cuda.synchronize()
        err = _max_err(torch, got, want)
        torch.testing.assert_close(got, want, **ART_TOL)
        err64 = _max_err(torch, got.double(), want64)
        plain64 = _max_err(torch, want.double(), want64)
        del want64
        print(f"  art_sweep {label}: max|kernel - plain| {err:.3g} (tol "
              f"1e-4 + 1e-4 relative); against float64: "
              f"kernel {err64:.3g}, plain {plain64:.3g}; max|f| "
              f"{float(want.abs().max()):.3g}", flush=True)
        ms = _time_ms(torch, call, reps=reps, warmup=1, flush=flush)
        plain_ms = _time_ms(torch, plain, reps=plain_reps,
                            warmup=1 if plain_reps > 1 else 0, flush=flush)
        bound, by = _csr_bound_ms(csr, nslice, iters)
        dense, dense_by = _dense_bound_ms(nrow, ncol, nslice, iters)
        print(f"    kernel {ms:.4f} ms ({ms * 1e3 / (nrow * iters):.3f} us a "
              f"row step); plain {plain_ms:.4f} ms; bound {bound:.4g} ms ({by}, the "
              f"{csr.col.numel()} non-zeros), dense bound {dense:.4g} ms "
              f"({dense_by}); library n/a", flush=True)
        return {"name": f"art_sweep ({label})", "route": "cuda",
                "source": "src/repro_torch/csrc/art.cu",
                "replaces": "src/repro/kernels/art/kernel.py:43",
                "max_abs_err": err, "err_vs_float64": err64,
                "plain_err_vs_float64": plain64, "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "dense_bound_ms": dense,
                "library_ms": None}

    rng = np.random.default_rng(SEED)
    variants = []
    for nrow, ncol in ART_SHAPES + (ART_ODD_SHAPE, ART_LONG_SHAPE):
        for iters in (1, 3):
            A = rng.standard_normal((nrow, ncol)).astype(np.float32)
            f_true = rng.standard_normal((3, ncol)).astype(np.float32)
            A_t = torch.from_numpy(A).to(dev)
            b = torch.from_numpy(f_true @ A.T).to(dev)
            f0 = torch.zeros((3, ncol), device=dev)
            variants.append(measure(
                f"{nrow}x{ncol}, 3 slices, {iters} "
                f"sweep{'s' if iters > 1 else ''}", A_t, b, f0, iters, 25))

    angles = np.linspace(-75, 75, NANGLES)
    t0 = time.perf_counter()
    A_host = make_system(NRAY, angles)
    t1 = time.perf_counter()
    A = torch.from_numpy(A_host).to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    csr = ao.csr_rows(A)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    nnz = csr.row_ptr[1:] - csr.row_ptr[:-1]
    print(f"  system matrix {tuple(A.shape)} fp32 "
          f"({A.numel() * 4 / 2**30:.2f} GiB): host build {t1 - t0:.2f} s, "
          f"copy to the card {t2 - t1:.2f} s, CSR on the card "
          f"{t3 - t2:.3f} s ({csr.col.numel()} non-zeros, "
          f"{8 * csr.col.numel() / 1e6:.1f} MB of columns and values); "
          f"non-zeros a row: mean {float(nnz.double().mean()):.1f}, min "
          f"{int(nnz.min())}, max {int(nnz.max())} of {A.shape[1]}",
          flush=True)
    del nnz
    vol = torch.from_numpy(make_phantom(NSLICE, NRAY, SEED)).to(dev)
    for lo, nslice, iters in ((124, 8, 1), (120, 16, 2)):
        b = project(A, vol[lo:lo + nslice]).contiguous()
        f0 = torch.zeros((nslice, NRAY * NRAY), device=dev)
        variants.append(measure(
            f"{A.shape[0]}x{A.shape[1]}, slices {lo}-{lo + nslice - 1}, "
            f"{iters} sweep{'s' if iters > 1 else ''}", A, b, f0, iters, 5,
            csr, plain_reps=ART_FULL_PLAIN_REPS))
    # one warp a slice: how a launch's time grows with its slices
    inv_rip = ao.inverse_row_norms(A)
    for nslice in (16, 128, 256):
        b = project(A, vol[:nslice]).contiguous()
        f0 = torch.zeros((nslice, NRAY * NRAY), device=dev)
        ms = _time_ms(torch, lambda: ak.art_sweep(csr, b, inv_rip, f0, 1.0,
                                                  1), reps=3, warmup=1)
        print(f"  occupancy: {nslice} slices, one sweep: {ms:.3f} ms, "
              f"{ms * 1e3 / A.shape[0]:.3f} us a row step, "
              f"{ms / nslice:.4f} ms a slice", flush=True)
    # the row of a stream launch: 16 slices, two sweeps
    return dict(variants[-1], name="art_sweep",
                max_abs_err=max(v["max_abs_err"] for v in variants),
                variants=variants)


def _join_pool_threads(before: set, timeout: float = 120.0) -> int:
    """Joins the RDD scheduler's pool threads started since ``before`` (an
    abandoned attempt runs on after its job returned); returns how many
    there were. Fails if one is still alive after ``timeout`` s."""
    import threading

    deadline = time.perf_counter() + timeout
    threads = [t for t in set(threading.enumerate()) - before
               if t.name.startswith("ThreadPoolExecutor")]
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
        if t.is_alive():
            raise AssertionError(f"pool thread {t.name} still running")
    return len(threads)


def tomo_phase(torch, dev, kernel_ms: float) -> tuple[int, dict]:
    """The §IV stream at full width, on the stream's default scheduler (4
    executors, speculation on); returns the ART launches it made and
    ``run_stream``'s result."""
    import threading

    import numpy as np

    from repro_torch import kernels
    from repro_torch.apps.tomo.solver import clear_system_cache
    from repro_torch.apps.tomo.stream import parse_args, run_stream

    clear_system_cache()            # a cold start: build and copy anew
    torch.cuda.empty_cache()
    out = OUT / "tomo"
    shutil.rmtree(out, ignore_errors=True)
    args = parse_args(TOMO_ARGS + ["--out", str(out), "--obs-port", "0"])
    before = set(threading.enumerate())
    kernels.reset_launch_counts()
    res = run_stream(args, device=dev)
    _join_pool_threads(before)
    counts = kernels.launch_counts()
    launches = counts["art_sweep"]
    sched = res["scheduler_metrics"]
    print(f"  partitions processed {res['partitions']}, launches {counts}, "
          f"scheduler metrics {sched}")
    # a speculative copy launches the kernel, and so does the attempt it
    # raced, so each one adds a launch
    want = res["partitions"] + sched["speculative"]
    if not launches == want == res["launches"] > 0:
        raise AssertionError(f"ART launches {launches} (run_stream reports "
                             f"{res['launches']}) != partitions processed "
                             f"{res['partitions']} + speculative copies "
                             f"{sched['speculative']}, or none")
    if any(n for name, n in counts.items() if name != "art_sweep"):
        raise AssertionError(f"other kernels launched: {counts}")
    if not np.isfinite(res["volume"]).all():
        raise AssertionError("non-finite values in the gathered volume")
    if res["volume"].shape != (NSLICE, NRAY, NRAY):
        raise AssertionError(f"volume shape {res['volume'].shape}")
    got = {"residual": (res["residual"], REF_RESIDUAL),
           "error": (res["error"], REF_ERROR)}
    for i, s in enumerate(REF_SLICES):
        got[f"slice {s} residual"] = (float(res["slice_residuals"][s]),
                                      REF_SLICE_RESIDUAL[i])
        got[f"slice {s} error"] = (float(res["slice_errors"][s]),
                                   REF_SLICE_ERROR[i])
    worst = max(abs(a - b) for a, b in got.values())
    print(f"  residual {res['residual']:.6f} (JAX {REF_RESIDUAL:.6f}), "
          f"volume error {res['error']:.6f} (JAX {REF_ERROR:.6f}); slices "
          f"{REF_SLICES.start}-{REF_SLICES.stop - 1} residuals "
          f"{[round(float(res['slice_residuals'][s]), 6) for s in REF_SLICES]}"
          f", errors "
          f"{[round(float(res['slice_errors'][s]), 6) for s in REF_SLICES]}; "
          f"max |port - JAX| {worst:.3g} (tol {REF_TOL})")
    bad = {k: v for k, v in got.items() if not abs(v[0] - v[1]) <= REF_TOL}
    if bad:
        raise AssertionError(f"off the JAX reference by more than {REF_TOL}:"
                             f" {bad}")
    # batches of NSLICE / PARTITIONS slices, each cut into PARTITIONS
    per = NSLICE // PARTITIONS // PARTITIONS
    want_keys = [f"slices-{i:04d}-{i + per - 1:04d}"
                 for i in range(0, NSLICE, per)]
    if res["sink_keys"] != want_keys:
        raise AssertionError(f"sink holds {res['sink_keys']}, expected "
                             f"{want_keys}")
    obs_report(res, len(res["batch_times"]), NSLICE, STREAM_STAGES)
    in_batches = sum(res["batch_times"])
    print(f"  set-up {res['setup_time']:.3f} s: system matrix host build "
          f"{res['matrix_build_time']:.3f} s, copy to the card with its "
          f"row norms and CSR {res['matrix_copy_time']:.3f} s")
    print(f"  stream OK: {len(res['batch_times'])} batches, batch times (s) "
          f"{[round(t, 4) for t in res['batch_times']]}, stream "
          f"{res['stream_time']:.3f} s ({in_batches:.3f} s in batches), "
          f"{NSLICE / res['stream_time']:.2f} slices/s; {launches} launches "
          f"x {kernel_ms:.1f} ms (phase 7, stream-launch shape) = "
          f"{launches * kernel_ms / 1e3 / res['stream_time']:.3f} of the "
          f"stream's wall time; {len(res['sink_keys'])} sink keys")
    return launches, res


def tomo_profile_phase(torch, dev) -> None:
    """Device time and idle share of one §IV batch (NSLICE / PARTITIONS
    slices in PARTITIONS RDD partitions) through the stream's own partition
    function, with the system already on the card."""
    import functools

    import numpy as np
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import kernels
    from repro_torch.apps.tomo.solver import TomoConfig, simulate_tilt_series
    from repro_torch.apps.tomo.stream import reconstruct_partition
    from repro_torch.core.rdd import Context

    cfg = TomoConfig(nray=NRAY, iterations=2, angles=tuple(
        np.linspace(-75, 75, NANGLES).tolist()))      # as run_stream's
    nslice = NSLICE // PARTITIONS
    _, _, sino = simulate_tilt_series(cfg, nslice, seed=SEED, device=dev)
    records = list(enumerate(sino))
    part = functools.partial(reconstruct_partition, config=cfg, device=dev)

    def batch():
        Context().parallelize(records, PARTITIONS).map_partitions(
            part).collect_partitions()      # each partition ends on the host

    t0 = time.perf_counter()                # wall time without the profiler
    batch()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for attempt in (1, 2):
        # the trace's first step can miss a launch: a warm-up step is traced
        # and dropped, the second batch is the one read
        # (active=2 and no second step: the window closes with the context,
        # which keeps its events)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=2)) as prof:
            batch()
            prof.step()
            before = kernels.launch_counts()["art_sweep"]
            batch()
            launched = kernels.launch_counts()["art_sweep"] - before
        seen = sum(1 for ev in prof.events() or ()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ART_KERNEL in ev.name)
        if seen == launched:
            break
        print(f"  profile {attempt}: the profiler saw {seen} of the "
              f"{launched} ART launches")
    else:
        print("  profile: launches missing from the trace; idle share not "
              "measured")
        return
    by_kernel = _device_us(torch, prof)
    busy_ms = sum(by_kernel.values()) / 1e3
    art_ms = sum(us for name, us in by_kernel.items()
                 if ART_KERNEL in name) / 1e3
    print(f"  one batch of {nslice} slices in {PARTITIONS} partitions: wall "
          f"{wall_ms:.3f} ms unprofiled; device busy {busy_ms:.3f} ms "
          f"(profiled, {seen} ART launches seen of {launched}), idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.4f}; the ART kernel "
          f"{art_ms:.3f} ms")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:10.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  "
              f"{name[:90]}")


GROUP, GROUP_TOPIC, GROUP_PARTITIONS = "tomo", "slices", 4
GROUP_HEARTBEAT, GROUP_SESSION = 0.05, 0.4
GROUP_VOLUME_RTOL = 1e-6
GROUP_DEADLINE_S = 120.0


def group_phase(torch, dev, tomo_volume, smi: str) -> int:
    """The §IV slices through a consumer group of two streaming contexts in
    threads of one process, each batch's ranges reconstructed by the ART
    kernel: one consumer goes silent after its second committed batch (no
    leave, no heartbeat), the survivor takes its partitions over, and the
    silent one's late commit is fenced. The volume is held to phase 8's,
    slice by slice; returns the ART launches."""
    import functools
    import threading

    import numpy as np

    from repro_torch import kernels
    from repro_torch.apps.tomo.solver import (TomoConfig, residual,
                                              simulate_tilt_series)
    from repro_torch.apps.tomo.stream import reconstruct_partition
    from repro_torch.core.broker import Broker
    from repro_torch.core.dstream import StreamingContext
    from repro_torch.core.rdd import Context
    from repro_torch.data.groups import StaleGenerationError
    from repro_torch.data.sinks import KeyedSink

    cfg = TomoConfig(nray=NRAY, iterations=2, angles=tuple(
        np.linspace(-75, 75, NANGLES).tolist()))      # as run_stream's
    vol_true, sino, sino_host = simulate_tilt_series(cfg, NSLICE, device=dev)
    broker = Broker()
    broker.create_topic(GROUP_TOPIC, GROUP_PARTITIONS)
    broker.produce_many(GROUP_TOPIC, [(f"slice-{i:06d}".encode(),
                                       (i, sino_host[i]))
                                      for i in range(NSLICE)])
    per_part = broker.end_offsets(GROUP_TOPIC)

    class VolumeSink(KeyedSink):
        def __init__(self):
            super().__init__()
            self.rows = {}

        def _write_one(self, key, value):
            self.rows[key] = value

    sink = VolumeSink()
    part = functools.partial(reconstruct_partition, config=cfg, device=dev)

    def process(rdd, info):
        # one RDD partition a range: one ART launch a range
        parts = rdd.map_partitions(part).collect_partitions()
        sink.write_batch([(f"slice-{i:04d}", block[j])
                          for idx, block in parts
                          for j, i in enumerate(idx)])

    ctxs = []
    for cid in ("survivor", "victim"):
        sc = StreamingContext(Context(), broker,
                              max_records_per_partition=NSLICE
                              // PARTITIONS // PARTITIONS)
        sc.subscribe([GROUP_TOPIC])
        sc.foreach_batch(process)
        sc.join_group(GROUP, consumer_id=cid,
                      heartbeat_interval=GROUP_HEARTBEAT,
                      session_timeout=GROUP_SESSION)
        ctxs.append(sc)
    survivor, victim = ctxs
    survivor.group_member.maintain(force=True)    # the settled split first
    gen_split = broker.describe_group(GROUP)["generation"]
    split = {c: list(a.get(GROUP_TOPIC, [])) for c, a in
             broker.describe_group(GROUP)["assignments"].items()}
    silent = {"at": None, "member": None}
    errors = []
    deadline = time.perf_counter() + GROUP_DEADLINE_S

    def run(sc, is_victim):
        try:
            while broker.lag(GROUP_TOPIC, group=GROUP) > 0:
                if time.perf_counter() > deadline:
                    raise AssertionError(
                        f"group lag {broker.lag(GROUP_TOPIC, group=GROUP)} "
                        f"after {GROUP_DEADLINE_S} s; sink "
                        f"{len(sink.rows)} of {NSLICE} slices")
                if sc.run_one_batch() is None:
                    time.sleep(0.0005)
                elif is_victim and len(sc.history) == 2:
                    # silent from here: no leave, no heartbeat
                    silent["member"] = (sc.group_member.consumer_id,
                                        sc.group_member.generation,
                                        sc.history[-1].ranges[0])
                    silent["at"] = time.perf_counter()
                    return
        except BaseException as e:                  # re-raised below
            errors.append(e)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(sc, sc is victim))
               for sc in ctxs]
    for th in threads:
        th.start()
    gap = None
    while any(th.is_alive() for th in threads):
        if gap is None and silent["at"] is not None and sum(
                len(ps) for ps in
                survivor.group_member.assignment.values()) == \
                GROUP_PARTITIONS:
            gap = time.perf_counter() - silent["at"]
        time.sleep(0.001)
    for th in threads:
        th.join()
    stream_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if errors:
        raise errors[0]
    if silent["at"] is None:
        raise AssertionError("the victim never committed two batches")
    if gap is None:     # the handoff landed between the last two polls
        gap = float("nan")
    ranges_run = sum(len(b.ranges) for sc in ctxs for b in sc.history)
    owned = sorted(p for ps in survivor.group_member.assignment.values()
                   for p in ps)
    d = broker.describe_group(GROUP)
    # the victim wakes once and commits what it had consumed
    vid, vgen, vrange = silent["member"]
    try:
        broker.commit(vrange.topic, vrange.partition, vrange.until,
                      group=GROUP, consumer=vid, generation=vgen)
        fenced = None
    except StaleGenerationError as e:
        fenced = str(e)
    lag = broker.lag(GROUP_TOPIC, group=GROUP)
    victim.group_member = None          # it died: no leave on close
    victim.close()
    survivor.close()

    recon = np.zeros((NSLICE, NRAY, NRAY), np.float32)
    for key, row in sink.rows.items():
        recon[int(key.split("-")[1])] = row
    rec = torch.from_numpy(recon).to(dev)
    res = residual(rec, sino, cfg)
    err = float(torch.linalg.vector_norm(rec - vol_true)
                / torch.linalg.vector_norm(vol_true))
    diff = np.linalg.norm((recon - tomo_volume).reshape(NSLICE, -1), axis=1)
    ref = np.linalg.norm(tomo_volume.reshape(NSLICE, -1), axis=1)
    rel = diff / np.maximum(ref, 1e-30)
    print(f"  {GROUP_TOPIC}: {NSLICE} slices keyed by slice index on "
          f"{GROUP_PARTITIONS} partitions {per_part}; split at generation "
          f"{gen_split} {split}; the victim silent after its 2nd batch "
          f"(generation {vgen}); the survivor owned {owned} at generation "
          f"{d['generation']} after {gap:.4f} s (session timeout "
          f"{GROUP_SESSION} s, heartbeat {GROUP_HEARTBEAT} s); batches: "
          f"survivor {len(survivor.history)}, victim {len(victim.history)}; "
          f"{ranges_run} ranges, launches {counts}; stream "
          f"{stream_s:.3f} s; sink {len(sink.rows)} slices, "
          f"{sink.skipped} processed twice; group lag {lag}; the victim's "
          f"late commit: {fenced}", flush=True)
    print(f"  group handoff OK on {smi}: residual {res:.6f} (JAX "
          f"{REF_RESIDUAL:.6f}), volume error {err:.6f} (JAX "
          f"{REF_ERROR:.6f}); max relative difference to phase 8's volume, "
          f"slice by slice, {rel.max():.3g} (tol {GROUP_VOLUME_RTOL}), "
          f"{int((diff == 0).sum())} of {NSLICE} slices bit-equal",
          flush=True)
    if len(sink.rows) != NSLICE:
        raise AssertionError(f"sink holds {len(sink.rows)} of {NSLICE}")
    if owned != list(range(GROUP_PARTITIONS)) or list(d["members"]) != \
            ["survivor"]:
        raise AssertionError(f"survivor owns {owned}; group {d}")
    if fenced is None:
        raise AssertionError("the victim's late commit was not fenced")
    if lag != 0:
        raise AssertionError(f"group lag {lag}")
    if not rel.max() <= GROUP_VOLUME_RTOL:
        raise AssertionError(f"volume off phase 8's by {rel.max()}")
    if not (abs(res - REF_RESIDUAL) <= REF_TOL
            and abs(err - REF_ERROR) <= REF_TOL):
        raise AssertionError(f"residual {res}, error {err} off the JAX "
                             f"reference by more than {REF_TOL}")
    launches = counts["art_sweep"]
    if not launches == ranges_run > 0 or any(
            n for name, n in counts.items() if name != "art_sweep"):
        raise AssertionError(f"launches {counts} for {ranges_run} ranges")
    return launches


# phase 21 (b): the first attempts at partition indices 0 (the first
# batch's broker read) and 1 (an ART partition) fail, and every attempt at
# index 2 that is not a speculative copy sleeps SCHED_SLOW_S first, far
# over the speculation threshold (4 x the median task, ~0.3 s here)
SCHED_FAIL = {0: 1, 1: 1}
SCHED_SLOW_S = 1.5
SCHED_VOLUME_RTOL = 1e-6


def scheduler_phase(torch, dev, tomo: dict, smi: str) -> dict:
    """Phase 21: the §IV stream at full width (TOMO_ARGS) through
    ``run_stream`` on a ``TaskScheduler`` of PARTITIONS executors with
    speculation, as ``examples/tomo_pipeline.py`` runs it, while phase 8's
    system is still on the card: (a) clean, (b) with a ``FailureInjector``
    losing partitions 0 and 1 once and slowing partition 2 in every batch.
    Each run's volume is held to phase 8's (``tomo``) slice by slice
    (relative 1e-6, bit-equal counted) and to the JAX reference's residual
    and error; its ART launches, read after the abandoned attempts' pool
    threads ended, to the partitions' results plus one launch per
    speculative copy (the copy's or the attempt it raced, whichever lost);
    (b)'s metrics to retries >= 2, speculative copies >= 4 and their wins
    >= 4. A lineage replay that fails fails the phase. Returns each run's
    ART launches."""
    import threading

    import numpy as np

    from repro_torch import kernels
    from repro_torch.apps.tomo.stream import parse_args, run_stream
    from repro_torch.core.rdd import FailureInjector, TaskScheduler

    runs = {}
    for label, injector in (
            ("a", None),
            ("b", FailureInjector(fail=dict(SCHED_FAIL),
                                  slow={2: SCHED_SLOW_S}))):
        out = OUT / f"tomo_scheduler_{label}"
        shutil.rmtree(out, ignore_errors=True)
        sched = TaskScheduler(num_executors=PARTITIONS, speculation=True,
                              failure_injector=injector)
        args = parse_args(TOMO_ARGS + ["--out", str(out)])
        before = set(threading.enumerate())
        kernels.reset_launch_counts()
        res = run_stream(args, device=dev, scheduler=sched)
        at_return = kernels.launch_counts()["art_sweep"]
        threads = _join_pool_threads(before)
        torch.cuda.synchronize(dev)
        counts = kernels.launch_counts()
        launches, m = counts["art_sweep"], res["scheduler_metrics"]
        if any(n for name, n in counts.items() if name != "art_sweep"):
            raise AssertionError(f"other kernels launched: {counts}")
        recon = res["volume"]
        if recon.shape != (NSLICE, NRAY, NRAY) or not np.isfinite(
                recon).all():
            raise AssertionError(f"volume of shape {recon.shape}, or not "
                                 f"finite")
        diff = np.linalg.norm((recon - tomo["volume"]).reshape(NSLICE, -1),
                              axis=1)
        ref = np.linalg.norm(tomo["volume"].reshape(NSLICE, -1), axis=1)
        rel = diff / np.maximum(ref, 1e-30)
        print(f"  ({label}) {'clean' if injector is None else 'faults'}: "
              f"scheduler metrics {m}; {res['partitions']} partitions' "
              f"results; residual {res['residual']:.6f}, volume error "
              f"{res['error']:.6f} (JAX {REF_RESIDUAL:.6f}, {REF_ERROR:.6f})"
              f"; to phase 8's volume, slice by slice: max relative "
              f"difference {rel.max():.3g} (tol {SCHED_VOLUME_RTOL}), "
              f"{int((diff == 0).sum())} of {NSLICE} slices bit-equal",
              flush=True)
        print(f"  ({label}) ART launches {launches} = {res['partitions']} "
              f"partitions' results (of them {m['speculative_wins']} by "
              f"speculative copies) + {launches - res['partitions']} "
              f"attempts that lost a race and ran anyway; "
              f"{launches - at_return} of them launched after run_stream "
              f"returned, read once the {threads} pool threads left behind "
              f"ended", flush=True)
        print(f"  ({label}) stream {res['stream_time']:.3f} s (phase 8 "
              f"{tomo['stream_time']:.3f} s), batch times (s) "
              f"{[round(t, 4) for t in res['batch_times']]} (phase 8 "
              f"{[round(t, 4) for t in tomo['batch_times']]}"
              + ("" if label == "a" else
                 f", (a) {[round(t, 4) for t in runs['a']['batch_times']]}")
              + ")", flush=True)
        if not rel.max() <= SCHED_VOLUME_RTOL:
            raise AssertionError(f"({label}) volume off phase 8's by "
                                 f"{rel.max()}")
        if not (abs(res["residual"] - REF_RESIDUAL) <= REF_TOL
                and abs(res["error"] - REF_ERROR) <= REF_TOL):
            raise AssertionError(f"({label}) residual {res['residual']} or "
                                 f"error {res['error']} off the JAX "
                                 f"reference by more than {REF_TOL}")
        if res["partitions"] != tomo["partitions"]:
            raise AssertionError(f"({label}) {res['partitions']} partitions, "
                                 f"phase 8 {tomo['partitions']}")
        if launches != res["partitions"] + m["speculative"]:
            raise AssertionError(f"({label}) ART launches {launches} != "
                                 f"{res['partitions']} partitions + "
                                 f"{m['speculative']} speculative copies")
        res["art_launches"] = launches
        runs[label] = res
    m = runs["b"]["scheduler_metrics"]
    if not (m["retries"] >= 2 and m["speculative"] >= 4
            and m["speculative_wins"] >= 4):
        raise AssertionError(f"(b) metrics {m}: expected retries >= 2, "
                             f"speculative >= 4 and speculative_wins >= 4")
    print(f"  the §IV stream on the TaskScheduler OK on {smi}: clean "
          f"{runs['a']['art_launches']} ART launches, with faults "
          f"{runs['b']['art_launches']}", flush=True)
    return {label: res["art_launches"] for label, res in runs.items()}


def _instance(mangled: str) -> str:
    """" hd N" for a kernel template's instance at head dim N, else ""."""
    import re

    m = re.search(r"kernelILi(\d+)E", mangled)
    return f" hd {m.group(1)}" if m else ""


def build_report(kernels: tuple[str, ...]) -> None:
    """ptxas's registers, shared memory and spills of ``kernels`` (from the
    build's log), and the tensor-core instructions in the SASS of the two
    flash kernels that use them (cuobjdump, next to nvcc): HGMMA in each
    instance of the wgmma kernel, TF32 HMMA in each of the tf32x3 one;
    raises if one has none."""
    import re

    from repro_torch.kernels import _build

    log = _build.BUILD_DIR / _build.LOG_NAME
    entry = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = next((k for k in kernels if k in m.group(1)), None)
            if entry:
                print(f"  ptxas {entry}{_instance(m.group(1))}:")
        elif entry and ("Used" in line or "spill" in line):
            print(f"    {line.split('ptxas info    :')[-1].strip()}")
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print(f"  cuobjdump not found next to nvcc ({cuobjdump}): the HGMMA "
              f"and HMMA counts are not measured")
        return
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.BUILD_DIR / _build.LIB_NAME)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and "HGMMA" in line:
            counts[fn, "HGMMA"] = counts.get((fn, "HGMMA"), 0) + 1
        elif fn and "HMMA" in line and "TF32" in line:
            counts[fn, "HMMA"] = counts.get((fn, "HMMA"), 0) + 1
    for kernel, op, what, dims in (
            ("flash_attention_wgmma", "HGMMA", "HGMMA", TC_HEAD_DIMS),
            ("flash_attention_tf32x3", "HMMA", "TF32 HMMA", TC_HEAD_DIMS)):
        total = sum(c for (_, o), c in counts.items() if o == op)
        for hd in dims:
            n = sum(c for (f, o), c in counts.items()
                    if kernel in f and o == op and _instance(f) == f" hd {hd}")
            print(f"  {what} instructions in {kernel}_kernel's SASS at hd "
                  f"{hd}: {n} (all functions: {total})")
            if n == 0:
                raise AssertionError(f"no {what} in {kernel}_kernel's SASS "
                                     f"at hd {hd}")


def sdpa_kernels(torch, dev) -> dict[str, str]:
    """The device kernels of ``scaled_dot_product_attention`` at the model
    shape, by dtype, by the profiler, with each one's time a call. Taken
    before any other trace in the process: a short trace after earlier
    ones came back empty on the card."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    names, calls = {}, 3
    for dtype in ("bfloat16", "float32"):
        q, k, v = (torch.randn(MODEL_B, MODEL_H, MODEL_S, MODEL_HD,
                               device=dev, dtype=getattr(torch, dtype))
                   for _ in range(3))
        F.scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
            torch.cuda.synchronize()
        seen = sorted(_device_us(torch, prof).items(), key=lambda kv: -kv[1])
        names[dtype] = "; ".join(f"{name} ({us / calls:.1f} us a call)"
                                 for name, us in seen) or "none seen"
        print(f"  SDPA's kernels in {dtype} at B {MODEL_B}, S {MODEL_S}, H "
              f"{MODEL_H}, hd {MODEL_HD} (profiler): {names[dtype]}",
              flush=True)
    return names


def flash_phase(torch, dev, flush) -> list[dict]:
    """The three flash kernels against their plain version (held to
    FLASH_TOL): at the test shapes (fp32 on the tf32x3 kernel, bf16 on the
    SIMT one); at hd 64, 128 and 256 the wgmma kernel (bf16) and the tf32x3
    kernel (fp32) at S 64 and 130 (one tile, a ragged last one), 1,000
    through ``ops`` and the prefill shape (B 4, S 1,024, H 16: internlm2's
    at hd 128, gemma-7b's at hd 256, B·H 64 at hd 64), and at hd 64 also
    granite-moe-3b-a800m's prefill (B 4, S 1,024, H 24). At the prefill
    shape each is timed beside its bound and PyTorch's
    ``scaled_dot_product_attention`` (timed for the table only), the tf32x3
    kernel also beside the fp32-FMA bound; the SIMT kernel is timed at the
    model's batch and sequence in bf16 at hd 32. Returns the rows of the
    kernels line, by their ``FLASH_ROWS`` key, each with the launches this
    phase made of its instances (``launches_kernel_checks``)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.flash_attention import ref as fr

    build_report(("flash_attention_wgmma_kernel",
                  "flash_attention_tf32x3_kernel", "art_csr_kernel"))
    if {(d, hd) for d, hds in FLASH_ROWS for hd in hds} != set(
            fk.INSTANCES):
        raise AssertionError(f"the flash rows {list(FLASH_ROWS)} do not "
                             f"cover the wrapper's instances {fk.INSTANCES}")
    rng = np.random.default_rng(SEED)
    kernels.reset_launch_counts()

    def qkv(shape, dtype):
        return [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, getattr(torch, dtype)) for _ in range(3)]

    def check(label, dtype, got, want):
        torch.cuda.synchronize()
        err = _max_err(torch, got.float(), want.float())
        tol = FLASH_TOL[dtype]
        print(f"  flash_attention {label}, {dtype}: max|kernel - plain| "
              f"{err:.3g} (tol {tol} + {tol} relative)", flush=True)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        return {"name": f"flash_attention ({label}, {dtype})",
                "max_abs_err": err}

    def designed(design, hd, fn):
        """Run ``fn``, asserting that its one launch went to ``design``'s
        instance at ``hd``."""
        before = dict(fk.flash_attention.launches_by_instance)
        out = fn()
        after = fk.flash_attention.launches_by_instance
        if {i: after[i] - before[i] for i in after} != {
                i: int(i == (design, hd)) for i in after}:
            raise AssertionError(f"expected one {design} launch at hd {hd}: "
                                 f"{before} -> {after}")
        return out

    variants = {key: [] for key in FLASH_ROWS}
    for S, hd in FLASH_SHAPES:
        for dtype in FLASH_TOL:
            design = fk.design_for(getattr(torch, dtype), hd)
            q, k, v = qkv((4, S, hd), dtype)
            got = designed(design, hd, lambda: fk.flash_attention(
                q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0])
            variants[_flash_row(design, hd)].append(check(f"{design}, BH 4, S {S}, hd {hd}",
                                          dtype, got,
                                          fr.attention_ref(q, k, v)))
    for hd in TC_HEAD_DIMS:
        for B, S, H in ((2, 64, 4), (2, 130, 4)):
            for dtype in FLASH_TOL:
                design = fk.design_for(getattr(torch, dtype), hd)
                q, k, v = qkv((B, S, H, hd), dtype)
                got = designed(design, hd,
                               lambda: fk.flash_attention(q, k, v))
                variants[_flash_row(design, hd)].append(check(
                    f"{design}, B {B}, S {S}, H {H}, hd {hd}", dtype, got,
                    fo.flash_attention(q, k, v, use_kernel=False)))
        for dtype in FLASH_TOL:     # the tail: 1,000 = 7 x 128 + 104
            design = fk.design_for(getattr(torch, dtype), hd)
            q, k, v = qkv((1, 1000, MODEL_H, hd), dtype)
            got = designed(design, hd, lambda: fo.flash_attention(q, k, v))
            variants[_flash_row(design, hd)].append(check(
                f"{design} through ops, B 1, S 1000, H {MODEL_H}, hd {hd}",
                dtype, got, fo.flash_attention(q, k, v, use_kernel=False)))
        for dtype in FLASH_TOL if hd == 64 else ():   # granite's prefill
            design = fk.design_for(getattr(torch, dtype), hd)
            q, k, v = qkv((MODEL_B, MODEL_S, MOE_H, hd), dtype)
            got = designed(design, hd, lambda: fk.flash_attention(q, k, v))
            variants[_flash_row(design, hd)].append(check(
                f"{design}, B {MODEL_B}, S {MODEL_S}, H {MOE_H}, hd {hd} "
                f"({MOE_ARCH}'s prefill)", dtype, got,
                fo.flash_attention(q, k, v, use_kernel=False)))
            del q, k, v, got
    rows = {}
    # the prefills at hd 128 and 256, and the SIMT kernel's largest head
    # dim at the model's batch and sequence
    timed = [(dtype, hd) for hd in TC_HEAD_DIMS for dtype in FLASH_TOL]
    timed.append(("bfloat16", max(hd for _, hd in FLASH_SHAPES)))
    for dtype, hd in timed:
        design = fk.design_for(getattr(torch, dtype), hd)
        shape = (MODEL_B, MODEL_S, MODEL_H, hd)
        q, k, v = qkv(shape, dtype)

        def call():
            return fk.flash_attention(q, k, v)

        def plain():
            return fo.flash_attention(q, k, v, use_kernel=False)

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        got = designed(design, hd, call)
        row = check(f"{design}, B {MODEL_B}, S {MODEL_S}, H {MODEL_H}, hd "
                    f"{hd}", dtype, got, plain())
        sdpa_err = _max_err(torch, got.float(),
                            library().transpose(1, 2).float())
        ms = _time_ms(torch, call, flush=flush)
        o_direct = torch.empty_like(q)

        def direct():
            _flash_direct(design, q, k, v, o_direct)
        direct_ms = _time_ms(torch, direct, flush=flush)
        if not torch.equal(o_direct, got):
            raise AssertionError("the operator's output differs from the "
                                 "same launch made directly")
        del o_direct
        plain_ms = _time_ms(torch, plain, flush=flush)
        library_ms = _time_ms(torch, library, flush=flush)
        # q, k, v read once and o written once; QK^T and PV over the causal
        # half, 2 operations a multiply-add, at the card's rate for the
        # type: bf16 on the tensor cores, fp32 as three TF32 products on
        # them (the tf32x3 kernel's work), the fp32 FMA rate beside it
        bh, elem = MODEL_B * MODEL_H, q.element_size()
        nbytes = 4 * bh * MODEL_S * hd * elem
        ops = 2 * 2 * bh * (MODEL_S * (MODEL_S + 1) / 2) * hd
        if dtype == "bfloat16":
            bound, by = _bound_ms(nbytes, ops, BF16_TC_OPS_PER_S)
            extra = ""
        else:
            bound, by = _bound_ms(nbytes, 3 * ops, TF32_TC_OPS_PER_S)
            fma_ms, fma_by = _bound_ms(nbytes, ops, FP32_OPS_PER_S)
            row.update(bound_fp32_fma_ms=fma_ms)
            extra = (f" (3 x {ops / 1e9:.2f} GFLOP of TF32 at "
                     f"{TF32_TC_OPS_PER_S / 1e12:.0f} TFLOP/s; fp32 FMA bound "
                     f"{fma_ms:.4f} ms ({fma_by}))")
        print(f"    {design} kernel at hd {hd} {ms:.4f} ms (through the "
              f"repro_torch::flash_attention operator; the same launch "
              f"without its dispatch {direct_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}){extra}, "
              f"library (SDPA) {library_ms:.4f} ms; max|kernel - SDPA| "
              f"{sdpa_err:.3g} (reported)", flush=True)
        row.update(ms=ms, direct_ms=direct_ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, library_ms=library_ms,
                   max_abs_err_vs_library=sdpa_err)
        key = _flash_row(design, hd)
        variants[key].append(row)
        rows[key] = row
    sources = {"wgmma": "src/repro_torch/csrc/flash_attention_wgmma.cu",
               "tf32x3": "src/repro_torch/csrc/flash_attention_tf32x3.cu",
               "simt": "src/repro_torch/csrc/flash_attention.cu"}
    replaces = "src/repro/kernels/flash_attention/kernel.py:79"
    checks = dict(fk.flash_attention.launches_by_instance)
    print(f"  launches of this phase by instance: {_launched(checks)}",
          flush=True)
    return {key: dict(rows[key], name=f"flash_attention ({name})",
                      route="cuda", source=sources[key[0]],
                      replaces=replaces, launches=0,
                      max_abs_err=max(v["max_abs_err"] for v in variants[key]),
                      launches_kernel_checks=_row_launches(checks, key),
                      variants=variants[key])
            for key, name in FLASH_ROWS.items()}


def _flash_direct(design: str, q, k, v, o) -> None:
    """One launch of ``design``'s kernel through the library's C entry,
    without the operator's dispatch and uncounted: phase 9 times it beside
    the operator's call."""
    from repro_torch.kernels import _build

    lib = _build.load_library()
    entry = {"wgmma": lib.flash_attention_wgmma_launch,
             "tf32x3": lib.flash_attention_tf32x3_launch,
             "simt": lib.flash_attention_launch}[design]
    B, S, H, hd = q.shape
    rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S,
               H, hd, _build.current_stream(q.device))
    _build.check_launch(f"flash_attention ({design}, direct)", rc)


def _flash_row(design: str, hd: int) -> tuple:
    """The ``FLASH_ROWS`` key whose row counts ``design`` at ``hd``."""
    return next(key for key in FLASH_ROWS if key[0] == design
                and hd in key[1])


def _row_launches(by_instance: dict, key: tuple) -> int:
    """The launches of a flash row: its design's at each of its head dims,
    from a run's per-instance counts."""
    return sum(by_instance.get((key[0], hd), 0) for hd in key[1])


def _launched(by_instance: dict) -> dict:
    """The instances a run launched, with their counts."""
    return {i: n for i, n in by_instance.items() if n}


def _param_count(params) -> int:
    if isinstance(params, dict):
        return sum(_param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(_param_count(v) for v in params)
    return params.numel()


def _draw(torch, dev, config):
    """The config's parameters drawn on the card from SEED, printed with
    their count and size."""
    from repro_torch.models.registry import get_model

    t0 = time.perf_counter()
    params = get_model(config).init(
        torch.Generator(device=dev).manual_seed(SEED), config)
    torch.cuda.synchronize()
    n = _param_count(params)
    size = n * torch.finfo(config.parameter_dtype).bits / 8
    experts = (f" a expert, {config.num_experts} experts top "
               f"{config.experts_per_token}" if config.num_experts else "")
    print(f"  {config.name}: {config.num_layers} layers, d_model "
          f"{config.d_model}, {config.num_heads}/{config.num_kv_heads} heads "
          f"of {config.resolved_head_dim}, d_ff {config.d_ff}{experts}, vocab "
          f"{config.vocab_size}: {n:,} parameters ({n / 1e9:.3f} B), "
          f"{size / 1e9:.2f} GB in {config.param_dtype}, drawn on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    return params


def prefill_check(torch, dev, config, params, rng) -> None:
    """The bf16 prefill of MODEL_B x MODEL_S tokens drawn from ``rng`` with
    the kernel (every launch on the wgmma kernel at the config's head dim,
    one a layer) against the naive attention: last-token logits within
    MAX_PREFILL_LOGIT_DIFF; both timed."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer

    tokens = torch.from_numpy(rng.integers(
        0, config.vocab_size, (MODEL_B, MODEL_S))).to(dev)
    naive = config.replace(attention_impl="naive")
    with torch.inference_mode():
        kernels.reset_launch_counts()
        lk, _ = transformer.prefill(params, {"tokens": tokens}, config)
        launched = kernels.launch_counts()["flash_attention"]
        by_instance = _launched(fk.flash_attention.launches_by_instance)
        ln, _ = transformer.prefill(params, {"tokens": tokens}, naive)
        ms_k = _time_ms(torch, lambda: transformer.prefill(
            params, {"tokens": tokens}, config), reps=3, warmup=1)
        ms_n = _time_ms(torch, lambda: transformer.prefill(
            params, {"tokens": tokens}, naive), reps=3, warmup=1)
    if not (torch.isfinite(lk).all() and torch.isfinite(ln).all()):
        raise AssertionError("non-finite prefill logits")
    if lk.shape != (MODEL_B, 1, config.vocab_size):
        raise AssertionError(f"logits shape {tuple(lk.shape)}")
    diff = _max_err(torch, lk.float(), ln.float())
    agree = int((lk.argmax(-1) == ln.argmax(-1)).sum())
    print(f"  bf16 prefill of {MODEL_B} x {MODEL_S} tokens: kernel "
          f"({launched} launches, {by_instance}) against naive attention: "
          f"last-token "
          f"logits max|diff| {diff:.4g} (limit {MAX_PREFILL_LOGIT_DIFF}; "
          f"max|logit| {float(ln.float().abs().max()):.3g}), greedy tokens "
          f"agree {agree}/{MODEL_B}; prefill {ms_k:.2f} ms with the kernel, "
          f"{ms_n:.2f} ms naive", flush=True)
    want = {("wgmma", config.resolved_head_dim): config.num_layers}
    if by_instance != want:
        raise AssertionError(f"flash launches {by_instance} in a bf16 "
                             f"prefill of {config.num_layers} layers, "
                             f"expected {want}")
    if not diff <= MAX_PREFILL_LOGIT_DIFF:
        raise AssertionError(f"kernel and naive prefill logits differ by "
                             f"{diff} > {MAX_PREFILL_LOGIT_DIFF}")


def invariant_check(torch, dev, config, rng) -> dict:
    """The serve invariant of tests/test_models.py:45-84 in full fp32 (B 2,
    S 256, 4 tokens drawn from ``rng``; every launch on the tf32x3 kernel)
    on parameters drawn here and released before it returns; returns the
    run's flash launches by instance."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 products would run in TF32")
    config = config.replace(dtype="float32", param_dtype="float32")
    params = _draw(torch, dev, config)
    B, S, G = 2, 256, 4
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size,
                                           (B, S))).to(dev)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        logits, cache = transformer.prefill(params, {"tokens": tokens},
                                            config, max_len=S + G)
        serve = [logits[:, -1].argmax(-1)]
        for _ in range(G - 1):
            logits, cache = transformer.decode_step(
                params, serve[-1][:, None], cache, config)
            serve.append(logits[:, -1].argmax(-1))
        full = tokens
        for g in range(G):
            logits2, _ = transformer.prefill(params, {"tokens": full}, config,
                                             max_len=full.shape[1] + 1)
            nxt = logits2[:, -1].argmax(-1)
            if not torch.equal(nxt, serve[g]):
                raise AssertionError(f"serve invariant broken at step {g}: "
                                     f"{nxt.tolist()} != {serve[g].tolist()}")
            full = torch.cat([full, nxt[:, None]], dim=1)
    by_instance = dict(fk.flash_attention.launches_by_instance)
    print(f"  fp32 serve invariant at full width (B {B}, S {S}, {G} tokens, "
          f"the kernel on, launches {_launched(by_instance)}): greedy "
          f"prefill + decode == teacher-forced prefills, tokens "
          f"{torch.stack(serve, 1).tolist()}", flush=True)
    want = {("tf32x3", config.resolved_head_dim):
            (1 + G) * config.num_layers}
    if _launched(by_instance) != want:
        raise AssertionError(f"flash launches {_launched(by_instance)} in "
                             f"{1 + G} fp32 prefills of {config.num_layers} "
                             f"layers, expected {want}")
    del params, cache, logits, logits2
    torch.cuda.empty_cache()
    return by_instance


def model_phase(torch, dev) -> dict:
    """internlm2-1.8b at full width: the prefill with the kernel against
    the naive attention (bf16, every launch on the wgmma kernel), then the
    serve invariant in fp32 (on the tf32x3 kernel), their tokens drawn in
    turn from one generator seeded with SEED. Returns the invariant's flash
    launches by instance."""
    import numpy as np

    from repro_torch.configs import get_config

    config = get_config(ARCH)
    rng = np.random.default_rng(SEED)
    params = _draw(torch, dev, config)
    prefill_check(torch, dev, config, params, rng)
    del params
    torch.cuda.empty_cache()
    return invariant_check(torch, dev, config, rng)


def _greedy(torch, params, config, prompts, gen: int, frames=None,
            images=None):
    """Greedy prefill + ``gen - 1`` decode steps of the config's family
    (over ``frames`` for the audio family, behind ``images`` for the vlm
    family, whose cache then holds the prefix too): the tokens (B, gen) on
    the host, and each token's logits (B, V) in fp32."""
    from repro_torch.models.registry import get_model

    model = get_model(config)
    batch = {"tokens": prompts}
    max_len = prompts.shape[1] + gen
    if frames is not None:
        batch["frames"] = frames
    if images is not None:
        batch["image_embeds"] = images
        max_len += images.shape[1]
    with torch.inference_mode():
        logits, cache = model.prefill(params, batch, config, max_len=max_len)
        steps = [logits[:, -1].float()]
        for _ in range(gen - 1):
            tok = steps[-1].argmax(-1, keepdim=True)
            logits, cache = model.decode_step(params, tok, cache, config)
            steps.append(logits[:, -1].float())
    return torch.stack([s.argmax(-1) for s in steps], 1).cpu(), steps


def serve_phase(torch, dev, argv=SERVE_ARGS, params=None,
                results: dict | None = None,
                served: dict | None = None) -> dict:
    """The serve stream at full width through ``run_serve`` on ``argv``,
    on ``params`` when given (else drawn from the seed); returns its flash
    launches by instance, every one of them on the wgmma kernel at the
    config's head dim. ``results``, when given, receives the served tokens
    by request id, and ``served`` what ``run_serve`` returned."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import parse_args, run_serve

    args = parse_args(argv)
    kernels.reset_launch_counts()
    res = run_serve(args, device=dev, params=params)
    counts = kernels.launch_counts()
    by_instance = dict(fk.flash_attention.launches_by_instance)
    n_layers = res["config"].num_layers
    hd = res["config"].resolved_head_dim
    batches = -(-args.requests // args.batch)
    want = batches * n_layers
    print(f"  launches {counts} (run_serve reports {res['launches']}), by "
          f"instance {_launched(by_instance)}; expected flash_attention {batches} batches x "
          f"{n_layers} layers = {want}, all wgmma at hd {hd}")
    if counts["flash_attention"] != want or res["launches"] != counts:
        raise AssertionError(f"flash launches {counts['flash_attention']} "
                             f"!= {want}")
    if _launched(by_instance) != {("wgmma", hd): want}:
        raise AssertionError(f"flash launches by instance "
                             f"{_launched(by_instance)}, not all {want} on "
                             f"the wgmma kernel at hd {hd}")
    if any(n for name, n in counts.items() if name != "flash_attention"):
        raise AssertionError(f"other kernels launched: {counts}")
    if results is not None:
        results.update(res["results"])
    if served is not None:
        served.update(res)
    results = res["results"]
    vocab = res["config"].vocab_size
    if sorted(results) != list(range(args.requests)) or any(
            len(t) != args.gen or not all(0 <= x < vocab for x in t)
            for t in results.values()):
        raise AssertionError(f"results {results}")
    print(f"  served {len(results)} requests x {args.gen} tokens "
          f"({res['tokens']} tokens) in {res['stream_s']:.3f} s: "
          f"{res['tokens_per_s']:.1f} tokens/s")
    print(f"  per batch: prefill (s) {[round(x, 4) for x in res['prefill_s']]}"
          f", decode of {args.gen - 1} steps (s) "
          f"{[round(x, 4) for x in res['decode_s']]}, time to first token "
          f"(s) {[round(x, 4) for x in res['ttft_s']]}")
    print(f"  realtime report {res['report']}; request 0 -> "
          f"{results[0][:8]}", flush=True)
    return by_instance


def _split_ms(torch, prof) -> tuple[float, float, float, float, int]:
    """A trace's device time in ms: all, the flash kernels', the GEMMs'
    (cuBLAS, the experts' ``bmm`` included), the MoE dispatch's (sorts,
    searchsorted, scatters, gathers: ``DISPATCH_MARKERS``, which in a dense
    model also match the embedding's gather); and the flash launches it
    saw."""
    by_kernel = _device_us(torch, prof)
    flash = {n: us for n, us in by_kernel.items()
             if any(k in n for k in FLASH_KERNELS)}
    gemm = {n: us for n, us in by_kernel.items() if n not in flash
            and any(m in n.lower() for m in GEMM_MARKERS)}
    dispatch = sum(us for n, us in by_kernel.items()
                   if n not in flash and n not in gemm
                   and any(m in n.lower() for m in DISPATCH_MARKERS))
    seen = sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and any(k in ev.name for k in FLASH_KERNELS))
    return (sum(by_kernel.values()) / 1e3, sum(flash.values()) / 1e3,
            sum(gemm.values()) / 1e3, dispatch / 1e3, seen)


def dense_profile(torch, dev, config, params, steps: int = 7) -> None:
    """Where a bf16 prefill of MODEL_B x MODEL_S tokens and the ``steps``
    decode steps after it spend the device's time: flash kernel, GEMMs and
    the rest (for an MoE model also its dispatch, and the prefill's ten
    largest kernels), by the profiler, beside each one's wall time
    (profiled; the host clock around work that ends in a synchronize).
    Reported: a trace that misses launches says so."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer

    rng = np.random.default_rng(SEED + 1)
    tokens = torch.from_numpy(rng.integers(
        0, config.vocab_size, (MODEL_B, MODEL_S))).to(dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        transformer.prefill(params, {"tokens": tokens}, config)  # warm
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, cache = transformer.prefill(
                params, {"tokens": tokens}, config, max_len=MODEL_S + steps)
            torch.cuda.synchronize()
            wall_p = (time.perf_counter() - t0) * 1e3
        split_p = _split_ms(torch, prof)
        top_p = sorted(_device_us(torch, prof).items(), key=lambda kv: -kv[1])
        tok = logits[:, -1:].argmax(-1)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = transformer.decode_step(params, tok, cache,
                                                        config)
                tok = logits[:, -1:].argmax(-1)
            torch.cuda.synchronize()
            wall_d = (time.perf_counter() - t0) * 1e3
        split_d = _split_ms(torch, prof)
    moe = config.num_experts > 0
    for what, wall, (busy, flash, gemm, disp, seen), n_flash in (
            ("prefill", wall_p, split_p, config.num_layers),
            (f"{steps} decode steps", wall_d, split_d, 0)):
        if busy == 0:
            print(f"  {config.name} {what}: the trace came back empty; "
                  f"its device time not measured", flush=True)
            continue
        if not moe:
            disp = 0.0
        print(f"  {config.name} {what} (profiled): wall {wall:.2f} ms, "
              f"device busy {busy:.2f} ms, idle share "
              f"{max(0.0, 1 - busy / wall):.3f}; flash {flash:.2f} ms "
              f"({seen} of {n_flash} launches seen), GEMMs {gemm:.2f} ms"
              + (f", MoE dispatch {disp:.2f} ms" if moe else "")
              + f", the rest {busy - flash - gemm - disp:.2f} ms",
              flush=True)
    for name, us in top_p[:10] if moe and split_p[0] else ():
        print(f"    {us / 1e3:9.3f} ms {100 * us / 1e3 / split_p[0]:5.1f}%  "
              f"{name[:90]}", flush=True)


def dense_phase(torch, dev, smi: str) -> dict:
    """Phase 19: gemma-7b, minitron-8b and starcoder2-3b at full width, each
    drawn from the seed in bf16 and released before the next: the prefill
    check (every layer on the wgmma kernel, at hd 256 for gemma-7b), then
    the serve stream through ``run_serve`` (gemma-7b 8 requests, the others
    one batch of 4, all 1,024 tokens in, every flash launch on the wgmma
    kernel); for gemma-7b also the fp32 serve invariant on the tf32x3
    kernel at hd 256, on fp32 parameters drawn after the bf16 ones left.
    Each arch's tokens come in turn from one generator seeded with SEED.
    Returns the flash launches by instance of the serve streams summed
    ("served") and of the invariant ("invariant")."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk

    out = {"served": dict.fromkeys(fk.INSTANCES, 0),
           "invariant": dict.fromkeys(fk.INSTANCES, 0)}
    t_phase = time.perf_counter()
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)     # the context up before its stats
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        config = get_config(arch)
        rng = np.random.default_rng(SEED)
        params = _draw(torch, dev, config)
        prefill_check(torch, dev, config, params, rng)
        argv = ["--arch", arch] + DENSE_SERVE_ARGS[arch]
        for i, n in serve_phase(torch, dev, argv, params=params).items():
            out["served"][i] += n
        dense_profile(torch, dev, config, params)
        del params
        torch.cuda.empty_cache()
        if config.resolved_head_dim == 256:
            out["invariant"] = invariant_check(torch, dev, config, rng)
        print(f"  {arch} done in {time.perf_counter() - t0:.1f} s, peak "
              f"device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
              f" GB, on {smi}", flush=True)
    print(f"  the dense configs at full width: flash launches served "
          f"{_launched(out['served'])}, in the fp32 invariant "
          f"{_launched(out['invariant'])}, in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


@contextlib.contextmanager
def _capture(module, name: str):
    """Records the first argument of every call of ``module.name`` inside
    the block (the model modules call each other through their module
    attributes)."""
    seen, fn = [], getattr(module, name)

    def recording(x, *args, **kw):
        seen.append(x)
        return fn(x, *args, **kw)

    setattr(module, name, recording)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def moe_prefill_check(torch, dev, config, params, rng) -> None:
    """The bf16 prefill of MODEL_B x MODEL_S tokens drawn from ``rng``, with
    the kernel (one wgmma launch a layer at the config's head dim) and with
    the naive attention, both timed. Held: each layer's attention output,
    the kernel against naive on that layer's normed input from the naive
    run (the model's own q, k and v), within the bf16 FLASH_TOL, at every
    layer. Reported, not held: the last-token logits' difference, and the
    share of routing decisions (a token's top-k set of experts at a layer)
    that differ between the two runs. Top-k routing is discontinuous: a
    bf16 rounding difference upstream flips a near-tied expert, and the
    layers after it see another sum of experts. That is the model's
    discontinuity, not the kernel's error, so for this family the per-layer
    attention check takes the place of the dense phases'
    MAX_PREFILL_LOGIT_DIFF."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import attention, moe, transformer

    tokens = torch.from_numpy(rng.integers(
        0, config.vocab_size, (MODEL_B, MODEL_S))).to(dev)
    naive = config.replace(attention_impl="naive")
    batch = {"tokens": tokens}
    T, K = MODEL_B * MODEL_S, config.experts_per_token
    with torch.inference_mode():
        with _capture(attention, "attention_layer") as attn_in, \
                _capture(moe, "moe_layer") as moe_in_n:
            ln, _ = transformer.prefill(params, batch, naive)
        kernels.reset_launch_counts()
        with _capture(moe, "moe_layer") as moe_in_k:
            lk, _ = transformer.prefill(params, batch, config)
        launched = kernels.launch_counts()["flash_attention"]
        by_instance = _launched(fk.flash_attention.launches_by_instance)
        ms_k = _time_ms(torch, lambda: transformer.prefill(
            params, batch, config), reps=3, warmup=1)
        ms_n = _time_ms(torch, lambda: transformer.prefill(
            params, batch, naive), reps=3, warmup=1)
        positions = torch.arange(MODEL_S, device=dev).expand(MODEL_B,
                                                             MODEL_S)
        tol = FLASH_TOL["bfloat16"]
        worst = (0.0, -1)
        for i, h in enumerate(attn_in):
            p = params["layers"][i]["attn"]
            ok, _ = attention.attention_layer(h, p, config, positions)
            on, _ = attention.attention_layer(h, p, naive, positions)
            err = _max_err(torch, ok.float(), on.float())
            worst = max(worst, (err, i))
            torch.testing.assert_close(ok.float(), on.float(), rtol=tol,
                                       atol=tol)
        by_layer = []
        for i, (xk, xn) in enumerate(zip(moe_in_k, moe_in_n)):
            router = params["layers"][i]["moe"]["router"]
            ek = moe.route(xk.reshape(T, -1), router, K)[2].sort(-1).values
            en = moe.route(xn.reshape(T, -1), router, K)[2].sort(-1).values
            by_layer.append(int((ek != en).any(-1).sum()))
        flips = sum(by_layer)
    if not (torch.isfinite(lk).all() and torch.isfinite(ln).all()):
        raise AssertionError("non-finite prefill logits")
    if lk.shape != (MODEL_B, 1, config.vocab_size):
        raise AssertionError(f"logits shape {tuple(lk.shape)}")
    n_layers = config.num_layers
    if len(attn_in) != n_layers or len(moe_in_k) != n_layers:
        raise AssertionError(f"captured {len(attn_in)} attention and "
                             f"{len(moe_in_k)} MoE inputs of {n_layers} "
                             f"layers")
    diff = _max_err(torch, lk.float(), ln.float())
    agree = int((lk.argmax(-1) == ln.argmax(-1)).sum())
    print(f"  bf16 prefill of {MODEL_B} x {MODEL_S} tokens: kernel "
          f"({launched} launches, {by_instance}) against naive attention: "
          f"each layer's attention output on the naive run's input within "
          f"{tol} at all {n_layers} layers (largest max|diff| "
          f"{worst[0]:.4g}, layer {worst[1]}); reported: last-token logits "
          f"max|diff| {diff:.4g} (max|logit| "
          f"{float(ln.float().abs().max()):.3g}), greedy tokens agree "
          f"{agree}/{MODEL_B}, routing decisions that differ {flips} of "
          f"{n_layers * T} (layers x tokens, share "
          f"{flips / (n_layers * T):.4g}; by layer {by_layer}: a flip "
          f"changes the token's later layers and, through attention, the "
          f"later tokens); prefill {ms_k:.2f} ms with the kernel, "
          f"{ms_n:.2f} ms naive", flush=True)
    want = {("wgmma", config.resolved_head_dim): n_layers}
    if by_instance != want:
        raise AssertionError(f"flash launches {by_instance} in a bf16 "
                             f"prefill of {n_layers} layers, expected {want}")


def moe_phase(torch, dev, smi: str) -> dict:
    """Phase 20: granite-moe-3b-a800m at full width, drawn from the seed in
    bf16: the prefill check (``moe_prefill_check``), the serve stream
    through ``run_serve`` at the published capacity factor (MOE_SERVE_ARGS,
    every flash launch on the wgmma kernel at hd 64), where its prefill and
    7 decode steps spend the device's time, then the fp32 serve invariant
    on the tf32x3 kernel at hd 64 on fp32 parameters drawn after the bf16
    ones left, at capacity factor E/k (5.0), drop-free at any T because a
    token picks an expert at most once; its tokens drawn in turn from one
    generator seeded with SEED. Returns the flash launches by instance of
    the serve stream ("served") and of the invariant ("invariant")."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity

    t0 = time.perf_counter()
    torch.cuda.synchronize(dev)         # the context up before its stats
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    config = get_config(MOE_ARCH)
    batch = int(MOE_SERVE_ARGS[MOE_SERVE_ARGS.index("--batch") + 1])
    print(f"  capacity a expert at factor {config.capacity_factor}: "
          f"{capacity(MODEL_B * MODEL_S, config)} slots in a prefill of "
          f"{MODEL_B} x {MODEL_S} tokens, {capacity(batch, config)} in a "
          f"decode step of {batch} (the reference's drops, reproduced)",
          flush=True)
    rng = np.random.default_rng(SEED)
    params = _draw(torch, dev, config)
    moe_prefill_check(torch, dev, config, params, rng)
    served = serve_phase(torch, dev, MOE_SERVE_ARGS, params=params)
    dense_profile(torch, dev, config, params)
    del params
    torch.cuda.empty_cache()
    free = config.replace(
        capacity_factor=config.num_experts / config.experts_per_token)
    invariant = invariant_check(torch, dev, free, rng)
    print(f"  {MOE_ARCH} at full width: flash launches served "
          f"{_launched(served)}, in the fp32 invariant (capacity factor "
          f"{free.capacity_factor}) {_launched(invariant)}; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
          f"{time.perf_counter() - t0:.1f} s, on {smi}", flush=True)
    return {"served": served, "invariant": invariant}


# phase 22: recurrentgemma-2b, served at full width; the prompt is longer
# than the 2,048-token window, so the prefill's mask matters, the cache
# keeps the last 2,048 keys rotated, and every decode step wraps in place
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_PROMPT = 2560
HYBRID_SERVE_ARGS = ["--arch", HYBRID_ARCH, "--requests", "8", "--batch",
                     "4", "--prompt-len", str(HYBRID_PROMPT), "--gen", "16",
                     "--seed", str(SEED)]
HYBRID_INVARIANT_B, HYBRID_INVARIANT_STEPS = 2, 8
# the profiled prefill's parts: the functions whose calls are labelled
HYBRID_PARTS = {"blocked attention": ("attention", "blocked_attention"),
                "RG-LRU scan": ("rglru", "_rg_lru"),
                "causal conv": ("rglru", "_causal_conv")}


@contextlib.contextmanager
def _labelled(parts: dict):
    """Every call of each part's function inside the block runs under a
    ``record_function`` of the part's name, so the profiler ties the
    kernels it launches to the part."""
    import importlib

    from torch.profiler import record_function

    saved = []
    for label, (mod, name) in parts.items():
        if not mod.startswith("repro_torch."):
            mod = f"repro_torch.models.{mod}"
        module = importlib.import_module(mod)
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*args, **kw)

        saved.append((module, name, fn))
        setattr(module, name, wrapped)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _split_by_part(torch, prof, labels) -> tuple[float, dict, dict, float]:
    """On the device's timeline: the kernels' busy time in ms, the time of
    the kernels that ran inside each label's spans (the profiler puts each
    ``record_function`` on the device's timeline too, spanning the kernels
    launched in it) with the GEMMs' share of each, and the GEMMs that ran
    in no span. The spans themselves are not counted as busy time."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = {label: [] for label in labels}
    kernels = []
    for ev in prof.events():
        if ev.device_type != cuda or ev.name.startswith("ProfilerStep"):
            continue
        if ev.name in spans:
            spans[ev.name].append((ev.time_range.start, ev.time_range.end))
        else:
            kernels.append(ev)
    part = dict.fromkeys(labels, 0.0)
    part_gemm = dict.fromkeys(labels, 0.0)
    busy = gemm = 0.0
    for ev in kernels:
        ms = ev.time_range.elapsed_us() / 1e3
        busy += ms
        t = ev.time_range.start
        label = next((name for name, ivs in spans.items()
                      if any(a <= t < b for a, b in ivs)), None)
        is_gemm = any(m in ev.name.lower() for m in GEMM_MARKERS)
        if label is not None:
            part[label] += ms
            part_gemm[label] += ms if is_gemm else 0.0
        elif is_gemm:
            gemm += ms
    return busy, part, part_gemm, gemm


def hybrid_profile(torch, dev, config, params, tokens) -> None:
    """Where a bf16 prefill of ``tokens`` spends the device's time: GEMMs,
    the blocked attention, the RG-LRU scan, the causal conv and the rest, by
    the profiler (each kernel given to the part whose span it ran in), with
    the idle share against the prefill's wall time (profiled; the host
    clock around work that ends in a synchronize). Reported: a trace that
    comes back empty says so."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import rglru

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        rglru.prefill(params, {"tokens": tokens}, config)       # warm
        torch.cuda.synchronize()
        with _labelled(HYBRID_PARTS), profile(activities=acts) as prof:
            t0 = time.perf_counter()
            rglru.prefill(params, {"tokens": tokens}, config)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    busy, part, part_gemm, gemm = _split_by_part(torch, prof, HYBRID_PARTS)
    if busy == 0:
        print(f"  (c) the profiled prefill's trace came back empty; its "
              f"device time not measured", flush=True)
        return
    if sum(part.values()) == 0:
        print("  (c) no kernel ran inside a part's span (the trace put no "
              "span on the device's timeline); the split is not measured",
              flush=True)
    rest = busy - gemm - sum(part.values())
    print(f"  (c) bf16 prefill of {tokens.shape[0]} x {tokens.shape[1]} "
          f"tokens (profiled): wall {wall:.2f} ms, device busy {busy:.2f} ms,"
          f" idle share {max(0.0, 1 - busy / wall):.3f}; GEMMs outside the "
          f"parts {gemm:.2f} ms, "
          + ", ".join(f"{k} {v:.2f} ms (GEMMs {part_gemm[k]:.2f})"
                      for k, v in part.items())
          + f", the rest {rest:.2f} ms", flush=True)
    top = sorted(((n, us) for n, us in _device_us(torch, prof).items()
                  if n not in HYBRID_PARTS), key=lambda kv: -kv[1])
    for name, us in top[:8]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / 1e3 / busy:5.1f}%  "
              f"{name[:90]}", flush=True)


def hybrid_invariant(torch, dev, config) -> None:
    """The serve invariant in full fp32 at full width, past the window:
    greedy prefill of a HYBRID_PROMPT-token prompt and decode steps equal
    the argmax of teacher-forced prefills, HYBRID_INVARIANT_STEPS tokens,
    every decode step at a position past the window; on fp32 parameters
    drawn here and released before it returns."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.models import rglru

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 products would run in TF32")
    config = config.replace(dtype="float32", param_dtype="float32")
    params = _draw(torch, dev, config)
    B, S, G = HYBRID_INVARIANT_B, HYBRID_PROMPT, HYBRID_INVARIANT_STEPS
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size,
                                           (B, S))).to(dev)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        logits, cache = rglru.prefill(params, {"tokens": tokens}, config,
                                      max_len=S + G)
        steps = [logits[:, -1]]
        for _ in range(G - 1):
            logits, cache = rglru.decode_step(
                params, steps[-1].argmax(-1)[:, None], cache, config)
            steps.append(logits[:, -1])
        serve = [step.argmax(-1) for step in steps]
        full, worst = tokens, 0.0
        for g in range(G):
            forced, _ = rglru.prefill(params, {"tokens": full}, config)
            worst = max(worst, _max_err(torch, forced[:, -1], steps[g]))
            nxt = forced[:, -1].argmax(-1)
            if not torch.equal(nxt, serve[g]):
                raise AssertionError(f"fp32 serve invariant broken at step "
                                     f"{g}: {nxt.tolist()} != "
                                     f"{serve[g].tolist()}")
            full = torch.cat([full, nxt[:, None]], dim=1)
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"kernels launched: {counts}")
    print(f"  (b) fp32 serve invariant at full width (B {B}, a {S}-token "
          f"prompt over the {config.local_window}-token window, {G} tokens, "
          f"decode at positions {S}-{S + G - 2}): greedy prefill + decode "
          f"== teacher-forced prefills, tokens "
          f"{torch.stack(serve, 1).tolist()}; reported: max |logit| "
          f"difference, each step against its teacher-forced prefill, "
          f"{worst:.3g}; in "
          f"{time.perf_counter() - t0:.2f} s; launches {counts}", flush=True)
    del params, cache, logits, forced
    torch.cuda.empty_cache()


def hybrid_phase(torch, dev, smi: str) -> dict:
    """Phase 22: recurrentgemma-2b at full width (26 layers, d_model
    2,560, 10/1 heads of hd 256, window 2,048, lru_width 2,560, vocabulary
    256,000), drawn from the seed in bf16: (a) the serve stream through
    ``run_serve`` (HYBRID_SERVE_ARGS: 2,560-token prompts, so each prefill
    masks by the window and rotates its last 2,048 keys into the cache and
    each decode step wraps), no kernel launched (the windowed prefill
    runs the blocked schedule, the reference's branch past
    ``attention_block_q``, and a decode step the naive attention), the
    first batch's tokens equal to the model's own prefill/decode_step loop;
    (c) the profiled prefill of that batch; (b) the fp32 invariant past the
    window on fp32 parameters drawn after the bf16 ones left. Returns the
    kernels' launches in (a)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_args, run_serve

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)         # the context up before its stats
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    config = get_config(HYBRID_ARCH)
    params = _draw(torch, dev, config)
    args = parse_args(HYBRID_SERVE_ARGS)
    kernels.reset_launch_counts()
    res = run_serve(args, device=dev, params=params)
    counts = kernels.launch_counts()
    results, gen = res["results"], args.gen
    if sorted(results) != list(range(args.requests)) or any(
            len(t) != gen or not all(0 <= x < config.vocab_size for x in t)
            for t in results.values()):
        raise AssertionError(f"results {results}")
    print(f"  (a) served {len(results)} requests of {args.prompt_len} tokens"
          f" x {gen} out ({res['tokens']} tokens) in {res['stream_s']:.3f} s:"
          f" {res['tokens_per_s']:.1f} tokens/s; per batch: prefill (s) "
          f"{[round(x, 4) for x in res['prefill_s']]}, decode step (ms) "
          f"{[round(1e3 * x / (gen - 1), 2) for x in res['decode_s']]}, time "
          f"to first token (s) {[round(x, 4) for x in res['ttft_s']]}; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} "
          f"GB", flush=True)
    print(f"  (a) launches {counts}: flash_attention 0, as the reference "
          f"rules for a window (it takes its kernel at window 0 only, "
          f"repro/models/attention.py:258), so the windowed prefill runs the "
          f"blocked schedule in both packages", flush=True)
    if any(counts.values()) or any(res["launches"].values()):
        raise AssertionError(f"kernels launched: {counts}")
    rng = np.random.default_rng(args.seed)      # run_serve's prompts
    prompts = np.stack([rng.integers(0, config.vocab_size,
                                     (args.prompt_len,), dtype=np.int32)
                        for _ in range(args.batch)]).astype(np.int64)
    batch0 = torch.from_numpy(prompts).to(dev)
    direct, _ = _greedy(torch, params, config, batch0, gen)
    served0 = torch.tensor([results[i] for i in range(args.batch)])
    print(f"  (a) batch 0's tokens against the model's own prefill/"
          f"decode_step loop: {int((direct == served0).all(1).sum())}/"
          f"{args.batch} requests equal", flush=True)
    if not torch.equal(direct, served0):
        raise AssertionError(f"served {served0.tolist()} != the direct loop "
                             f"{direct.tolist()}")
    hybrid_profile(torch, dev, config, params, batch0)
    del params
    torch.cuda.empty_cache()
    hybrid_invariant(torch, dev, config)
    print(f"  {HYBRID_ARCH} at full width OK: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
          f"{time.perf_counter() - t_phase:.1f} s, on {smi}", flush=True)
    return counts


# phase 23: whisper-medium, served at full width: 1,500 frames a request,
# prompts of 384 tokens and 64 out (448, the decoder's context in
# arXiv:2212.04356); the request count is the cut, to one batch of 4 (8
# took the whole script past 350 s)
AUDIO_ARCH = "whisper-medium"
AUDIO_PARAMS = 793_101_312      # the reference's init, by jax.eval_shape
AUDIO_PROMPT, AUDIO_GEN = 384, 64
AUDIO_SERVE_ARGS = ["--arch", AUDIO_ARCH, "--requests", "4", "--batch", "4",
                    "--prompt-len", str(AUDIO_PROMPT), "--gen",
                    str(AUDIO_GEN), "--seed", str(SEED)]
AUDIO_INVARIANT_B, AUDIO_INVARIANT_STEPS = 2, 8
# an attention_layer call's kind -> its label in the profiled prefill
ATTENTION_KINDS = {"encoder": "encoder self-attention",
                   "cross": "cross-attention",
                   "decoder": "decoder self-attention"}


def _audio_requests(torch, dev, config, rng, n: int, prompt_len: int):
    """``n`` requests drawn from ``rng`` as ``run_serve`` draws them (each
    prompt, then its frames): tokens (n, S) and fp32 frames (n,
    encoder_seq, d_model) on the card."""
    import numpy as np

    prompts, frames = [], []
    for _ in range(n):
        prompts.append(rng.integers(0, config.vocab_size, (prompt_len,),
                                    dtype=np.int32))
        frames.append(rng.standard_normal(
            (config.encoder_seq, config.d_model)).astype(np.float32))
    return (torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev),
            torch.from_numpy(np.stack(frames)).to(dev))


@contextlib.contextmanager
def _attention_calls(labels: bool = False):
    """Every ``attention_layer`` call inside the block, by kind: "encoder"
    (non-causal self-attention), "cross" (``kv_source`` or
    ``precomputed_kv``) and "decoder" (causal self-attention). Yields
    {kind: [calls, flash launches, blocked calls]}, the launches read from
    the wrapper's count around each call and the blocked calls counted by
    a wrapper of ``blocked_attention``; with ``labels``, each call also
    runs under a ``record_function`` named by ``ATTENTION_KINDS``."""
    from torch.profiler import record_function

    from repro_torch import kernels
    from repro_torch.models import attention

    fn, blocked = attention.attention_layer, attention.blocked_attention
    seen = {kind: [0, 0, 0] for kind in ATTENTION_KINDS}
    tiled = [0]

    def counted(*args, **kw):
        tiled[0] += 1
        return blocked(*args, **kw)

    def wrapped(x, params, config, positions, cache=None, kv_source=None,
                precomputed_kv=None, causal=True, window=0):
        kind = ("cross" if kv_source is not None or precomputed_kv is not None
                else "decoder" if causal else "encoder")
        before = kernels.launch_counts()["flash_attention"], tiled[0]
        with (record_function(ATTENTION_KINDS[kind]) if labels
              else contextlib.nullcontext()):
            out = fn(x, params, config, positions, cache=cache,
                     kv_source=kv_source, precomputed_kv=precomputed_kv,
                     causal=causal, window=window)
        seen[kind][0] += 1
        seen[kind][1] += kernels.launch_counts()["flash_attention"] - before[0]
        seen[kind][2] += tiled[0] - before[1]
        return out

    attention.attention_layer = wrapped
    attention.blocked_attention = counted
    try:
        yield seen
    finally:
        attention.attention_layer = fn
        attention.blocked_attention = blocked


def audio_prefill_check(torch, dev, config, params, tokens, frames) -> None:
    """The bf16 prefill of ``tokens`` over ``frames`` with the kernel and
    with the naive attention: last-token logits within
    MAX_PREFILL_LOGIT_DIFF; the calls by kind: the kernel launched exactly
    once a decoder layer (its causal self-attention, on the wgmma kernel at
    hd 64) and never from the encoder or from cross-attention, and the
    blocked schedule run once an encoder layer (1,500 frames past
    ``attention_block_q``, the reference's branch) and nowhere else; both
    timed."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import whisper

    naive = config.replace(attention_impl="naive")
    batch = {"tokens": tokens, "frames": frames}
    n = config.num_layers
    with torch.inference_mode():
        kernels.reset_launch_counts()
        with _attention_calls() as calls:
            lk, _ = whisper.prefill(params, batch, config)
        launched = kernels.launch_counts()["flash_attention"]
        by_instance = _launched(fk.flash_attention.launches_by_instance)
        ln, _ = whisper.prefill(params, batch, naive)
        ms_k = _time_ms(torch, lambda: whisper.prefill(params, batch, config),
                        reps=3, warmup=1)
        ms_n = _time_ms(torch, lambda: whisper.prefill(params, batch, naive),
                        reps=3, warmup=1)
    if not (torch.isfinite(lk).all() and torch.isfinite(ln).all()):
        raise AssertionError("non-finite prefill logits")
    if lk.shape != (tokens.shape[0], 1, config.vocab_size):
        raise AssertionError(f"logits shape {tuple(lk.shape)}")
    diff = _max_err(torch, lk.float(), ln.float())
    agree = int((lk.argmax(-1) == ln.argmax(-1)).sum())
    print(f"  bf16 prefill of {tokens.shape[0]} x {tokens.shape[1]} tokens "
          f"over {frames.shape[1]} frames: attention calls [calls, flash "
          f"launches, blocked calls] {calls}; kernel ({launched} launches, "
          f"{by_instance}) "
          f"against naive attention: last-token logits max|diff| {diff:.4g} "
          f"(limit {MAX_PREFILL_LOGIT_DIFF}; max|logit| "
          f"{float(ln.float().abs().max()):.3g}), greedy tokens agree "
          f"{agree}/{tokens.shape[0]}; prefill {ms_k:.2f} ms with the kernel, "
          f"{ms_n:.2f} ms naive", flush=True)
    want = {"encoder": [config.encoder_layers, 0, config.encoder_layers],
            "cross": [n, 0, 0], "decoder": [n, n, 0]}
    if calls != want:
        raise AssertionError(f"attention calls {calls}, expected {want}")
    if by_instance != {("wgmma", config.resolved_head_dim): n}:
        raise AssertionError(f"flash launches {by_instance} in a bf16 "
                             f"prefill of {n} decoder layers")
    if not diff <= MAX_PREFILL_LOGIT_DIFF:
        raise AssertionError(f"kernel and naive prefill logits differ by "
                             f"{diff} > {MAX_PREFILL_LOGIT_DIFF}")


def audio_profile(torch, dev, config, params, tokens, frames) -> None:
    """Where a bf16 prefill spends the device's time, by the profiler: the
    encoder's self-attention calls (blocked), the cross-attention calls
    (naive) and the decoder's self-attention calls (flash), each with its
    GEMMs, then the GEMMs outside the attention calls and the rest, each
    kernel given to the attention call whose span it ran in; the idle share
    against the prefill's wall time (profiled; the host clock around work
    that ends in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import whisper

    batch = {"tokens": tokens, "frames": frames}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        whisper.prefill(params, batch, config)                   # warm
        torch.cuda.synchronize()
        with _attention_calls(labels=True), profile(activities=acts) as prof:
            t0 = time.perf_counter()
            whisper.prefill(params, batch, config)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    labels = list(ATTENTION_KINDS.values())
    busy, part, part_gemm, gemm = _split_by_part(torch, prof, labels)
    if busy == 0:
        print("  the profiled prefill's trace came back empty; its device "
              "time not measured", flush=True)
        return
    if sum(part.values()) == 0:
        print("  no kernel ran inside an attention call's span (the trace "
              "put no span on the device's timeline); the split is not "
              "measured", flush=True)
    by_kernel = _device_us(torch, prof)
    flash = sum(us for name, us in by_kernel.items()
                if any(k in name for k in FLASH_KERNELS)) / 1e3
    enc, cross, dec = (ATTENTION_KINDS[k] for k in ATTENTION_KINDS)
    print(f"  bf16 prefill of {tokens.shape[0]} x {tokens.shape[1]} tokens "
          f"(profiled): wall {wall:.2f} ms, device busy {busy:.2f} ms, idle "
          f"share {max(0.0, 1 - busy / wall):.3f}; the encoder's "
          f"self-attention calls {part[enc]:.2f} ms (GEMMs "
          f"{part_gemm[enc]:.2f}: the projections in bf16 and the blocked "
          f"schedule's fp32 products), cross-attention {part[cross]:.2f} ms "
          f"(GEMMs {part_gemm[cross]:.2f}), the decoder's self-attention "
          f"{part[dec]:.2f} ms (flash {flash:.2f}, GEMMs "
          f"{part_gemm[dec]:.2f}), GEMMs outside the attention calls "
          f"{gemm:.2f} ms, the rest {busy - sum(part.values()) - gemm:.2f} ms",
          flush=True)
    top = sorted(((n, us) for n, us in by_kernel.items() if n not in labels),
                 key=lambda kv: -kv[1])
    for name, us in top[:8]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / 1e3 / busy:5.1f}%  "
              f"{name[:90]}", flush=True)


def audio_invariant(torch, dev, config) -> dict:
    """The serve invariant in full fp32 at full width: greedy prefill of
    AUDIO_PROMPT tokens over a request's frames and decode steps equal the
    argmax of teacher-forced prefills over the same frames,
    AUDIO_INVARIANT_STEPS tokens, every prefill's decoder self-attention on
    the tf32x3 kernel at hd 64; on fp32 parameters drawn here and released
    before it returns. Returns the flash launches by instance."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import whisper

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 products would run in TF32")
    config = config.replace(dtype="float32", param_dtype="float32")
    params = _draw(torch, dev, config)
    B, S, G = AUDIO_INVARIANT_B, AUDIO_PROMPT, AUDIO_INVARIANT_STEPS
    tokens, frames = _audio_requests(torch, dev, config,
                                     np.random.default_rng(SEED + 3), B, S)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        logits, cache = whisper.prefill(
            params, {"tokens": tokens, "frames": frames}, config,
            max_len=S + G)
        steps = [logits[:, -1]]
        for _ in range(G - 1):
            logits, cache = whisper.decode_step(
                params, steps[-1].argmax(-1)[:, None], cache, config)
            steps.append(logits[:, -1])
        serve = [step.argmax(-1) for step in steps]
        full, worst = tokens, 0.0
        for g in range(G):
            forced, _ = whisper.prefill(
                params, {"tokens": full, "frames": frames}, config,
                max_len=full.shape[1] + 1)
            worst = max(worst, _max_err(torch, forced[:, -1], steps[g]))
            nxt = forced[:, -1].argmax(-1)
            if not torch.equal(nxt, serve[g]):
                raise AssertionError(f"fp32 serve invariant broken at step "
                                     f"{g}: {nxt.tolist()} != "
                                     f"{serve[g].tolist()}")
            full = torch.cat([full, nxt[:, None]], dim=1)
    by_instance = dict(fk.flash_attention.launches_by_instance)
    want = {("tf32x3", config.resolved_head_dim): (1 + G) * config.num_layers}
    print(f"  fp32 serve invariant at full width (B {B}, {S} tokens over "
          f"{config.encoder_seq} frames, {G} tokens, launches "
          f"{_launched(by_instance)}): greedy prefill + decode == "
          f"teacher-forced prefills, tokens {torch.stack(serve, 1).tolist()};"
          f" reported: max |logit| difference, each step against its "
          f"teacher-forced prefill, {worst:.3g}; in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if _launched(by_instance) != want:
        raise AssertionError(f"flash launches {_launched(by_instance)} in "
                             f"{1 + G} fp32 prefills, expected {want}")
    del params, cache, logits, forced
    torch.cuda.empty_cache()
    return by_instance


def audio_phase(torch, dev, smi: str) -> dict:
    """Phase 23: whisper-medium at full width (24 + 24 layers, d_model
    1,024, 16/16 heads of hd 64, vocabulary 51,865, 1,500 frames), drawn
    from the seed in bf16: the prefill check on the first served batch's
    requests (``audio_prefill_check``), the serve stream through
    ``run_serve`` (AUDIO_SERVE_ARGS; every flash launch on the wgmma kernel
    at hd 64, one a decoder layer a batch), the first batch's tokens against
    the model's own prefill/decode_step loop, the profiled prefill, then
    the fp32 serve invariant on the tf32x3 kernel on fp32 parameters drawn
    after the bf16 ones left. Returns the flash launches by instance of the
    serve stream ("served") and of the invariant ("invariant")."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_args

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)         # the context up before its stats
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    config = get_config(AUDIO_ARCH)
    params = _draw(torch, dev, config)
    if _param_count(params) != AUDIO_PARAMS:
        raise AssertionError(f"{_param_count(params)} parameters, the "
                             f"reference's init has {AUDIO_PARAMS}")
    args = parse_args(AUDIO_SERVE_ARGS)
    tokens, frames = _audio_requests(torch, dev, config,
                                     np.random.default_rng(args.seed),
                                     args.batch, args.prompt_len)
    audio_prefill_check(torch, dev, config, params, tokens, frames)
    results: dict = {}
    served = serve_phase(torch, dev, AUDIO_SERVE_ARGS, params=params,
                         results=results)
    # run_serve's first batch holds the prefill check's requests
    direct, _ = _greedy(torch, params, config, tokens, args.gen,
                        frames=frames)
    served0 = torch.tensor([results[i] for i in range(args.batch)])
    print(f"  batch 0's tokens against the model's own prefill/decode_step "
          f"loop over the same frames: "
          f"{int((direct == served0).all(1).sum())}/{args.batch} requests "
          f"equal", flush=True)
    if not torch.equal(direct, served0):
        raise AssertionError(f"served {served0.tolist()} != the direct loop "
                             f"{direct.tolist()}")
    audio_profile(torch, dev, config, params, tokens, frames)
    peak_bf16 = torch.cuda.max_memory_allocated(dev) / 1e9
    del params
    torch.cuda.empty_cache()
    invariant = audio_invariant(torch, dev, config)
    print(f"  {AUDIO_ARCH} at full width OK: flash launches served "
          f"{_launched(served)}, in the fp32 invariant {_launched(invariant)};"
          f" peak device memory {peak_bf16:.2f} GB in bf16, "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB with the fp32 "
          f"invariant; {time.perf_counter() - t_phase:.1f} s, on {smi}",
          flush=True)
    return {"served": served, "invariant": invariant}


# phase 24: rwkv6-7b, served at full width; the request count is the cut,
# to one batch of 4, as phase 23's
SSM_ARCH = "rwkv6-7b"
SSM_PARAMS = 7_534_944_256      # the reference's init, by jax.eval_shape
SSM_SERVE_ARGS = ["--arch", SSM_ARCH, "--requests", "4", "--batch", "4",
                  "--prompt-len", "1024", "--gen", "16", "--seed", str(SEED)]
SSM_INVARIANT_B, SSM_INVARIANT_PROMPT, SSM_INVARIANT_STEPS = 2, 256, 8
# tests/test_models.py:102's chunked-against-recurrent tolerance, held here
# as a share of the largest magnitude compared: at full width the WKV's
# output reaches thousands, where one fp32 step is larger than 2e-4
WKV_TOL = 2e-4
SSM_PARTS = {"WKV": ("rwkv6", "_wkv_chunked")}


def ssm_wkv_check(torch, dev, config, params, tokens) -> None:
    """On the last layer's own r, k, v, log w, u and (zero) entering state
    from a bf16 prefill of ``tokens`` at full width: the chunked WKV against
    the recurrent one, held to the reference's chunked-against-recurrent
    tolerance (WKV_TOL) of the largest magnitude compared, output and
    state, both timed; each one's distance from a float64 recurrence on the
    same inputs reported."""
    from repro_torch.models import rwkv6

    fn, seen = rwkv6._wkv_chunked, []

    def recording(r, k, v, logw, u, state, chunk):
        # the entering state is the cache's slice, written over in place
        # once the layer ends: keep a copy
        seen[:] = [(r, k, v, logw, u, state.clone())]
        return fn(r, k, v, logw, u, state, chunk)

    rwkv6._wkv_chunked = recording
    try:
        with torch.inference_mode():
            rwkv6.prefill(params, {"tokens": tokens}, config)
    finally:
        rwkv6._wkv_chunked = fn
    args = seen[0]
    C = config.rwkv_chunk
    with torch.inference_mode():
        yc, sc = rwkv6._wkv_chunked(*args, C)
        yr, sr = rwkv6._wkv_recurrent(*args)
        y64, s64 = rwkv6._wkv_recurrent(*(t.double() for t in args))
        ms_c = _time_ms(torch, lambda: rwkv6._wkv_chunked(*args, C), reps=5,
                        warmup=1)
        ms_r = _time_ms(torch, lambda: rwkv6._wkv_recurrent(*args), reps=1,
                        warmup=0)
    w = torch.exp(args[3])
    y_max, s_max = float(yr.abs().max()), float(sr.abs().max())
    print(f"  the last layer's WKV from the prefill, r/k/v/log w "
          f"{tuple(yr.shape)} fp32, decay w in [{float(w.min()):.4g}, "
          f"{float(w.max()):.6g}]: chunked (chunk {C}) against recurrent: "
          f"max|y diff| {_max_err(torch, yc, yr):.4g} of max|y| {y_max:.5g}, "
          f"max|S diff| {_max_err(torch, sc, sr):.4g} of max|S| "
          f"{s_max:.5g} (held: {WKV_TOL} of the largest magnitude); against "
          f"a float64 recurrence: max|y diff| chunked "
          f"{_max_err(torch, yc.double(), y64):.4g}, recurrent "
          f"{_max_err(torch, yr.double(), y64):.4g}; chunked {ms_c:.3f} ms, "
          f"recurrent {ms_r:.3f} ms", flush=True)
    torch.testing.assert_close(yc, yr, rtol=WKV_TOL,
                               atol=WKV_TOL * max(1.0, y_max))
    torch.testing.assert_close(sc, sr, rtol=WKV_TOL,
                               atol=WKV_TOL * max(1.0, s_max))


def ssm_profile(torch, dev, config, params, tokens) -> None:
    """Where a bf16 prefill of ``tokens`` spends the device's time: the
    chunked WKV (its batched products included), the GEMMs outside it and
    the rest, by the profiler, with the idle share against the prefill's
    wall time (profiled)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import rwkv6

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        rwkv6.prefill(params, {"tokens": tokens}, config)        # warm
        torch.cuda.synchronize()
        with _labelled(SSM_PARTS), profile(activities=acts) as prof:
            t0 = time.perf_counter()
            rwkv6.prefill(params, {"tokens": tokens}, config)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    busy, part, part_gemm, gemm = _split_by_part(torch, prof, SSM_PARTS)
    if busy == 0:
        print("  the profiled prefill's trace came back empty; its device "
              "time not measured", flush=True)
        return
    if sum(part.values()) == 0:
        print("  no kernel ran inside the WKV's spans (the trace put no span "
              "on the device's timeline); the split is not measured",
              flush=True)
    print(f"  bf16 prefill of {tokens.shape[0]} x {tokens.shape[1]} tokens "
          f"(profiled): wall {wall:.2f} ms, device busy {busy:.2f} ms, idle "
          f"share {max(0.0, 1 - busy / wall):.3f}; WKV {part['WKV']:.2f} ms "
          f"(its batched products {part_gemm['WKV']:.2f}), GEMMs outside it "
          f"{gemm:.2f} ms, the rest {busy - gemm - part['WKV']:.2f} ms",
          flush=True)
    top = sorted(((n, us) for n, us in _device_us(torch, prof).items()
                  if n not in SSM_PARTS), key=lambda kv: -kv[1])
    for name, us in top[:8]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / 1e3 / busy:5.1f}%  "
              f"{name[:90]}", flush=True)


def ssm_invariant(torch, dev, config) -> None:
    """The serve invariant in full fp32 at full width: greedy prefill of an
    SSM_INVARIANT_PROMPT-token prompt and decode steps equal the argmax of
    teacher-forced prefills, SSM_INVARIANT_STEPS tokens; on fp32 parameters
    drawn here and released before it returns."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.models import rwkv6

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 products would run in TF32")
    config = config.replace(dtype="float32", param_dtype="float32")
    params = _draw(torch, dev, config)
    B, S, G = SSM_INVARIANT_B, SSM_INVARIANT_PROMPT, SSM_INVARIANT_STEPS
    rng = np.random.default_rng(SEED + 4)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size,
                                           (B, S))).to(dev)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        logits, cache = rwkv6.prefill(params, {"tokens": tokens}, config)
        steps = [logits[:, -1]]
        for _ in range(G - 1):
            logits, cache = rwkv6.decode_step(
                params, steps[-1].argmax(-1)[:, None], cache, config)
            steps.append(logits[:, -1])
        serve = [step.argmax(-1) for step in steps]
        full, worst = tokens, 0.0
        for g in range(G):
            forced, _ = rwkv6.prefill(params, {"tokens": full}, config)
            worst = max(worst, _max_err(torch, forced[:, -1], steps[g]))
            nxt = forced[:, -1].argmax(-1)
            if not torch.equal(nxt, serve[g]):
                raise AssertionError(f"fp32 serve invariant broken at step "
                                     f"{g}: {nxt.tolist()} != "
                                     f"{serve[g].tolist()}")
            full = torch.cat([full, nxt[:, None]], dim=1)
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"kernels launched: {counts}")
    print(f"  fp32 serve invariant at full width (B {B}, a {S}-token prompt, "
          f"{G} tokens): greedy prefill + decode == teacher-forced "
          f"prefills, tokens {torch.stack(serve, 1).tolist()}; reported: "
          f"max |logit| difference, each step against its teacher-forced "
          f"prefill, {worst:.3g}; in {time.perf_counter() - t0:.2f} s; "
          f"launches {counts}", flush=True)
    del params, cache, logits, forced
    torch.cuda.empty_cache()


def ssm_phase(torch, dev, smi: str) -> dict:
    """Phase 24: rwkv6-7b at full width (32 layers, d_model 4,096, 64 heads
    of 64, d_ff 14,336, vocabulary 65,536), drawn from the seed in bf16:
    the serve stream through ``run_serve`` (SSM_SERVE_ARGS), no kernel
    launched (the reference has no Pallas kernel for the WKV), the first
    batch's tokens equal to the model's own loop; the chunked WKV against
    the recurrent one on a layer's own inputs; the profiled prefill; then
    the fp32 serve invariant on fp32 parameters drawn after the bf16 ones
    left. Returns the kernels' launches in the serve stream."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_args, run_serve

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)         # the context up before its stats
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    config = get_config(SSM_ARCH)
    params = _draw(torch, dev, config)
    if _param_count(params) != SSM_PARAMS:
        raise AssertionError(f"{_param_count(params)} parameters, the "
                             f"reference's init has {SSM_PARAMS}")
    args = parse_args(SSM_SERVE_ARGS)
    kernels.reset_launch_counts()
    res = run_serve(args, device=dev, params=params)
    counts = kernels.launch_counts()
    results, gen = res["results"], args.gen
    if sorted(results) != list(range(args.requests)) or any(
            len(t) != gen or not all(0 <= x < config.vocab_size for x in t)
            for t in results.values()):
        raise AssertionError(f"results {results}")
    print(f"  served {len(results)} requests of {args.prompt_len} tokens x "
          f"{gen} out ({res['tokens']} tokens) in {res['stream_s']:.3f} s: "
          f"{res['tokens_per_s']:.1f} tokens/s; per batch: prefill (s) "
          f"{[round(x, 4) for x in res['prefill_s']]}, decode step (ms) "
          f"{[round(1e3 * x / (gen - 1), 2) for x in res['decode_s']]}, time "
          f"to first token (s) {[round(x, 4) for x in res['ttft_s']]}; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} "
          f"GB; launches {counts}", flush=True)
    if any(counts.values()) or any(res["launches"].values()):
        raise AssertionError(f"kernels launched: {counts}")
    rng = np.random.default_rng(args.seed)      # run_serve's prompts
    prompts = np.stack([rng.integers(0, config.vocab_size,
                                     (args.prompt_len,), dtype=np.int32)
                        for _ in range(args.batch)]).astype(np.int64)
    batch0 = torch.from_numpy(prompts).to(dev)
    direct, _ = _greedy(torch, params, config, batch0, gen)
    served0 = torch.tensor([results[i] for i in range(args.batch)])
    print(f"  batch 0's tokens against the model's own prefill/decode_step "
          f"loop: {int((direct == served0).all(1).sum())}/{args.batch} "
          f"requests equal", flush=True)
    if not torch.equal(direct, served0):
        raise AssertionError(f"served {served0.tolist()} != the direct loop "
                             f"{direct.tolist()}")
    ssm_wkv_check(torch, dev, config, params, batch0)
    ssm_profile(torch, dev, config, params, batch0)
    peak_bf16 = torch.cuda.max_memory_allocated(dev) / 1e9
    del params
    torch.cuda.empty_cache()
    ssm_invariant(torch, dev, config)
    print(f"  {SSM_ARCH} at full width OK: peak device memory "
          f"{peak_bf16:.2f} GB in bf16, "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB with the fp32 "
          f"invariant; {time.perf_counter() - t_phase:.1f} s, on {smi}",
          flush=True)
    return counts


def serve_profile_phase(torch, dev) -> None:
    """One served batch (4 prompts of 1,024 tokens, 32 tokens out) through
    ``run_serve`` on weights drawn from the same seed: its tokens against
    the model's own prefill/decode_step loop, the same loop with the naive
    attention (reported), then its device time by kernel and idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_args, run_serve
    from repro_torch.models import transformer

    args = parse_args(SERVE_ARGS[2:] + ["--requests", "4"])
    config = get_config(args.arch)
    params = transformer.init(torch.Generator(device=dev).manual_seed(
        args.seed), config)
    res = run_serve(args, device=dev, params=params)   # warm
    res = run_serve(args, device=dev, params=params)   # unprofiled wall
    wall_ms = res["stream_s"] * 1e3
    # the same prompts through the model's own prefill/decode_step loop
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(np.stack([
        rng.integers(0, config.vocab_size, (args.prompt_len,), dtype=np.int32)
        for _ in range(args.requests)]).astype(np.int64)).to(dev)
    direct, lk = _greedy(torch, params, config, prompts, args.gen)
    if [res["results"][i] for i in range(args.requests)] != direct.tolist():
        raise AssertionError("run_serve's tokens differ from the model's "
                             "own prefill/decode_step loop")
    print(f"  run_serve's {args.requests} x {args.gen} tokens equal the "
          f"model's prefill/decode_step loop on the same prompts", flush=True)
    # replayed with the naive attention (reported): where a request's
    # tokens first part, both runs saw the same context, so the top-2 logit
    # gaps there say whether the kernel's rounding tipped a near tie
    naive, ln = _greedy(torch, params, config.replace(attention_impl="naive"),
                        prompts, args.gen)
    same = [bool((direct[i] == naive[i]).all()) for i in range(args.requests)]
    print(f"  the batch replayed with naive attention: {sum(same)}/"
          f"{args.requests} requests give the same {args.gen} tokens "
          f"(reported)", flush=True)
    for i in (i for i in range(args.requests) if not same[i]):
        t = int((direct[i] != naive[i]).nonzero()[0, 0])
        gk = lk[t][i].topk(2).values
        gn = ln[t][i].topk(2).values
        print(f"    request {i}: first differs at token {t} of {args.gen}; "
              f"top-2 logit gap there {float(gk[0] - gk[1]):.4g} with the "
              f"kernel, {float(gn[0] - gn[1]):.4g} naive; max|logit diff| "
              f"{float((lk[t][i] - ln[t][i]).abs().max()):.4g}", flush=True)
    for attempt in (1, 2):
        before = kernels.launch_counts()["flash_attention"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_serve(args, device=dev, params=params)
        launched = kernels.launch_counts()["flash_attention"] - before
        busy_ms, flash_ms, gemm_ms, _, seen = _split_ms(torch, prof)
        if seen == launched:
            break
        print(f"  profile {attempt}: the profiler saw {seen} of the "
              f"{launched} flash launches")
    else:
        print("  profile: launches missing from the trace; idle share not "
              "measured")
        return
    by_kernel = _device_us(torch, prof)
    print(f"  one batch (4 x {args.prompt_len} tokens, {args.gen} out): "
          f"wall {wall_ms:.3f} ms unprofiled (prefill "
          f"{res['prefill_s'][0] * 1e3:.3f} ms, decode "
          f"{res['decode_s'][0] * 1e3:.3f} ms); device busy {busy_ms:.3f} ms "
          f"(profiled, {seen} flash launches seen of {launched}), idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.4f}; flash kernel "
          f"{flash_ms:.3f} ms, GEMMs {gemm_ms:.3f} ms, the rest "
          f"{busy_ms - flash_ms - gemm_ms:.3f} ms")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3:10.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  "
              f"{name[:90]}")


def restart_phase(torch, dev, smi: str) -> None:
    """The restart-safe windowed path at Table II size: run_restart kills a
    spawned consumer mid-window and resumes it; the windows are then held
    to an uncrashed in-process run of each window on the card."""
    from repro_torch import kernels
    from repro_torch.apps.ptycho.sim import simulate
    from repro_torch.apps.ptycho.solver import SolverConfig
    from repro_torch.apps.ptycho.stream import (parse_args,
                                                reconstruct_window,
                                                run_restart)

    args = parse_args(RESTART_ARGS + ["--out", str(OUT / "restart")])
    kernels.reset_launch_counts()
    res = run_restart(args, device=dev)
    counts = kernels.launch_counts()
    want = {f"win-{k:04d}": list(range(k * RESTART_WINDOW,
                                       (k + 1) * RESTART_WINDOW))
            for k in range(RESTART_WINDOWS)}
    got = {k: w["frames"] for k, w in res["windows"].items()}
    if got != want:
        raise AssertionError(f"restart window set {sorted(got)} != "
                             f"{sorted(want)}")
    fired = res["fired_on_resume"]
    if not set(want) - set(res["windows_at_crash"]) <= set(fired):
        raise AssertionError(f"the resumed run fired {fired}, but "
                             f"{res['windows_at_crash']} were on disk")
    steps = len(fired) * RESTART_ITERS
    expect = {"modulus_project": steps, "raar_combine": steps,
              "overlap_products": len(fired) * (2 * RESTART_ITERS - 2),
              "art_sweep": 0, "flash_attention": 0}
    if counts != expect or res["launches"] != expect:
        raise AssertionError(f"resumed launches {counts} (run_restart "
                             f"reports {res['launches']}) != {expect}")
    problem = simulate(args.obj_size, args.probe_size, args.scan_step,
                       device=dev)
    positions = torch.as_tensor(problem.positions, device=dev)
    cfg = SolverConfig(beta=0.75, iterations=RESTART_ITERS)
    worst = 0.0
    for key, win in sorted(res["windows"].items()):
        ref = reconstruct_window(problem, positions, win["frames"],
                                 RESTART_ITERS, cfg)
        rel = abs(win["fourier_err"] - ref) / abs(ref)
        worst = max(worst, rel)
        print(f"  {key}: fourier err {win['fourier_err']:.6f}, uncrashed "
              f"{ref:.6f}, rel. diff {rel:.3g}")
        if not (math.isfinite(ref) and rel <= RESTART_RTOL):
            raise AssertionError(f"{key}: restart error {win['fourier_err']}"
                                 f" vs uncrashed {ref} (rtol {RESTART_RTOL})")
    print(f"  restart OK on {smi}: SIGKILL at offset {res['kill_offset']} "
          f"({res['kill_offset'] % RESTART_WINDOW} frames in the open "
          f"window), on disk at the crash {res['windows_at_crash']}; the "
          f"resumed run fired {len(fired)} windows with launches {counts}; "
          f"{len(got)} windows of {RESTART_WINDOW} frames, max rel. diff "
          f"{worst:.3g} (tol {RESTART_RTOL}); produce {res['produce_s']:.4f}"
          f" s, reopen (log, state, checkpoint) {res['reopen_s']:.4f} s, "
          f"resumed run {res['resume_s']:.4f} s", flush=True)


HA_ARGS = ["--frames", "512", "--obj-size", "448", "--probe-size", "64"]
HA_FRAMES, HA_RTOL = 512, 1e-6


def ha_phase(torch, dev, smi: str) -> None:
    """Broker HA under the card's consumer: a durable primary in its own
    process SIGKILLed after 256 of 512 §III frames, its follower promoted,
    the producer and the consumer each failing over through their own
    ``FailoverBroker``; every frame held to the simulated one and the
    card's reductions to numpy's, the zombie fenced, no segment left."""
    from repro_torch import kernels
    from repro_torch.apps.ptycho.ha_failover import (PARTITIONS, parse_args,
                                                     run_ha_failover)

    args = parse_args(HA_ARGS)
    kernels.reset_launch_counts()
    res = run_ha_failover(args, device=dev)
    counts = kernels.launch_counts()
    # numpy over the frames read back from the promoted broker, each held
    # bit for bit to the producer's by its CRC-32
    want = {"photons": res["readback_photons"], "peak": res["readback_peak"]}
    errs = {k: abs(res[k] - v) / abs(v) for k, v in want.items()}
    prod, cons = res["producer"], res["consumer"]
    side = args.probe_size
    print(f"  {res['frames']} frames of ({side}, {side}) fp32 "
          f"({res['frames'] * side * side * 4 / 2**20:.1f} MiB) on "
          f"{PARTITIONS} partitions, the primary SIGKILLed after "
          f"{res['kill_after']}: "
          f"{len(res['frame_ids'])} frame ids in the sink, the last "
          f"{res['last_frame_s']:.4f} s after the topic appeared "
          f"({res['frames'] / res['last_frame_s']:.1f} frames/s); kill to "
          f"the producer's next frame {res['kill_to_first_produce_s']:.4f} "
          f"s; {prod['produce_calls']} produce calls in "
          f"{prod['produce_s']:.4f} s ({prod['before_kill_s']:.4f} s "
          f"before the kill), flushed {prod['flushed']}; "
          f"{res['stored']} records on the promoted broker, "
          f"{res['duplicates']} duplicates from the resend window, read "
          f"back equal {res['readback_equal']}; failovers: producer "
          f"{prod['failovers']} (epoch {prod['epoch']}), consumer "
          f"{cons['failovers']} (epoch {cons['epoch']}), "
          f"{cons['cursors_rewound']} cursors rewound, {cons['records']} "
          f"records consumed; {res['realtime']['batches']} batches, mean "
          f"processing {res['realtime']['mean_processing_s'] * 1e3:.3f} "
          f"ms; launches {counts}", flush=True)
    print(f"  ha failover OK on {smi}: zombie fenced ({res['fenced']}: "
          f"{res['zombie_error']}); photons {res['photons']:.6e} (numpy "
          f"{want['photons']:.6e}), peak {res['peak']:.6f} (numpy "
          f"{want['peak']:.6f}), rel. diff {max(errs.values()):.3g} (tol "
          f"{HA_RTOL}); shm left by this run's processes "
          f"{res['shm_left']}", flush=True)
    ids = list(range(HA_FRAMES))
    if not (res["frames"] == HA_FRAMES and res["frame_ids"] == ids
            and res["readback_ids"] == ids and res["readback_equal"]):
        raise AssertionError(f"frames {res['frames']}, sink ids "
                             f"{len(res['frame_ids'])}, read back "
                             f"{len(res['readback_ids'])}, equal "
                             f"{res['readback_equal']} (mismatched "
                             f"{res['readback_mismatched'][:8]})")
    if not max(errs.values()) <= HA_RTOL:
        raise AssertionError(f"card {res['photons']}, {res['peak']} vs "
                             f"numpy {want}")
    for name, client in (("producer", prod), ("consumer", cons)):
        if not (client["failovers"] >= 1 and client["epoch"] == 1):
            raise AssertionError(f"{name}: {client}")
    if not (prod["flushed"] and res["zombie_error"] and res["fenced"]):
        raise AssertionError(f"flushed {prod['flushed']}, zombie "
                             f"{res['zombie_error']}, fenced {res['fenced']}")
    if res["shm_left"]:
        raise AssertionError(f"shm left: {res['shm_left']}")
    if any(counts.values()):
        raise AssertionError(f"kernels launched: {counts}")


# -- phases 16-18: the compute plane ---------------------------------------
QUICKSTART_N = 2_000_000             # the paper's 2M-float payload
BRIDGE_INT8_REL = 0.05               # tests/test_multidevice.py:62
GROUP_WORLD, GROUP_ITERS = 2, 6
# the 2-rank RAAR chain against the one-process chain on the same frames:
# |a - b| / |b| of each output (L2 norms), as tests/test_torch_bridge.py
# holds its 4-rank chain
GROUP_REL = 1e-5
GROUP_TIMEOUT_S = 600
ELASTIC_ARGS = PAPER_ARGS + ["--elastic", "--batch-frames", "64",
                             "--iters-per-batch", "6", "--final-iters", "60"]
RECOVERY_STEPS, RECOVERY_EVERY, RECOVERY_SLOTS = 12, 4, 4
RECOVERY_FAILURES = {6: 1}
RECOVERY_REL = 1e-5
OWN_ROWS = ("modulus_project", "overlap_products", "raar_combine")


def _rel(torch, got, want) -> float:
    """|got - want| / |want| in the L2 norm, on the host in float64."""
    g = torch.as_tensor(got).to("cpu", torch.complex128)
    w = torch.as_tensor(want).to("cpu", torch.complex128)
    return float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w).clamp_min(1e-30))


def _ptycho_frames(dev, frames: int):
    """Phase 5's §III problem on the card: the first ``frames`` frames'
    magnitudes and positions, the true probe and the starting waves."""
    from repro_torch.apps.ptycho.sim import simulate
    from repro_torch.apps.ptycho.solver import init_waves
    problem = simulate(256, 64, 8, device=dev)
    mags = problem.magnitudes[:frames]
    psi = init_waves(mags, problem.probe_true)
    return (psi, mags, problem.positions[:frames], problem.probe_true,
            tuple(problem.object_true.shape))


def _raar_chain(psi, mags, pos, probe, shape, iters: int,
                group=None):
    from repro_torch.apps.ptycho.solver import SolverConfig, raar_step
    cfg = SolverConfig()
    for it in range(iters):
        psi, obj, probe, err = raar_step(psi, mags, pos, probe, shape, cfg,
                                         it, group=group)
    return psi, obj, probe, err


def _group_rank(rank: int, world: int, init: str, device: str,
                results) -> None:
    """One of phase 16's two processes on the card: the bridge over a gloo
    group with CUDA tensors, its all-reduces, then the RAAR chain on this
    rank's half of the frames with ``group=``."""
    import traceback
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist
    try:
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        try:
            from repro_torch import kernels
            from repro_torch.core.bridge import TorchBridge
            from repro_torch.core.rdd import Context

            bridge = TorchBridge(device=dev, group=dist.group.WORLD)
            rng = np.random.default_rng(SEED + 16)
            parts = [rng.standard_normal(QUICKSTART_N).astype(np.float32)
                     for _ in range(world)]
            rdd = Context().from_partitions(
                [torch.from_numpy(p).to(dev) for p in parts])
            out = {}
            for op, comp in (("sum", None), ("max", None), ("mean", None),
                             ("int8", "int8")):
                try:
                    got = bridge.allreduce(rdd, "sum" if comp else op,
                                           compression=comp)
                    torch.cuda.synchronize()
                    out[op] = got.cpu().numpy()
                    out[op + "_ms"] = _time_ms(torch, lambda: bridge.allreduce(
                        rdd, "sum" if comp else op, compression=comp),
                        reps=10, warmup=2)
                except RuntimeError as exc:
                    raise RuntimeError(f"gloo all_reduce for {op!r} on CUDA "
                                       f"tensors failed: {exc}") from exc
            psi, mags, pos, probe, shape = _ptycho_frames(dev, F)
            lo, hi = rank * F // world, (rank + 1) * F // world
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            psi, obj, probe, err = _raar_chain(
                psi[lo:hi].contiguous(), mags[lo:hi].contiguous(),
                pos[lo:hi], probe, shape, GROUP_ITERS, group=bridge.group)
            torch.cuda.synchronize()
            out["raar_s"] = time.perf_counter() - t0
            out["launches"] = kernels.launch_counts()
            out.update(psi=psi.cpu().numpy(), obj=obj.cpu().numpy(),
                       probe=probe.cpu().numpy(), err=float(err),
                       coords=bridge.pmi.kvs().snapshot())
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def _spawn_group(world: int, tmp: Path, dev, target=None,
                 extra: tuple = ()) -> list[dict]:
    """``target`` (``_group_rank`` by default) in ``world`` spawned
    processes, each given (rank, world, the store's URL, the device, the
    results queue, *extra); every process is stopped before this returns,
    and a rank that raises, dies or outlives the time limit fails the
    phase."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{tmp / 'gloo_store'}"
    procs = [ctx.Process(target=target or _group_rank,
                         args=(r, world, init, str(dev), results, *extra),
                         daemon=True) for r in range(world)]
    got: dict[int, dict] = {}
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks gave no result in "
                                     f"{GROUP_TIMEOUT_S} s")
            try:
                rank, err, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got}
                if dead:
                    raise AssertionError(f"ranks died: exit codes {dead}")
                continue
            if err is not None:
                raise AssertionError(f"rank {rank} failed:\n{err}")
            got[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"rank exit codes {[p.exitcode for p in procs]}")
    return [got[r] for r in range(world)]


def bridge_phase(torch, dev, smi: str) -> dict:
    """Phase 16: the bridge over NCCL at world 1 in this process (the
    quickstart's two reductions at 2M floats, sum, max and mean exact
    against numpy, int8 within 0.05), then two processes on the card over
    gloo with CUDA tensors (the all-reduces against numpy, and the RAAR
    chain at 512 frames split in halves with ``group=``, held to the
    one-process chain)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch.apps.quickstart import make_payload, run_quickstart
    from repro_torch.core.bridge import TorchBridge
    from repro_torch.core.rdd import Context

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "nccl_store"), 1),
            rank=0, world_size=1, device_id=dev)
        try:
            bridge = TorchBridge(device=dev, group=dist.group.WORLD)
            t0 = time.perf_counter()
            res = run_quickstart(QUICKSTART_N, bridge=bridge)
            quick_s = time.perf_counter() - t0
            mpi = res["mpi"].cpu().numpy()
            if not (mpi[-1] == 5.0 and res["driver"][-1] == 5.0
                    and np.array_equal(mpi, res["driver"])
                    and np.array_equal(mpi, make_payload())):
                raise AssertionError(f"quickstart: driver {res['driver'][-3:]}"
                                     f", all-reduce {mpi[-3:]}")
            part = np.random.default_rng(SEED + 16).standard_normal(
                QUICKSTART_N).astype(np.float32)
            rdd = Context().from_partitions([torch.from_numpy(part).to(dev)])
            times = {}
            for op in ("sum", "max", "mean"):
                got = bridge.allreduce(rdd, op).cpu().numpy()
                if not np.array_equal(got, part):    # world 1: exact
                    raise AssertionError(f"NCCL {op} at world 1 differs "
                                         f"from numpy by "
                                         f"{np.abs(got - part).max()}")
                times[op] = _time_ms(torch, lambda op=op: bridge.allreduce(
                    rdd, op), reps=20)
            got = bridge.allreduce(rdd, compression="int8").cpu().numpy()
            int8_rel = float(np.linalg.norm(got - part)
                             / np.linalg.norm(part))
            if not int8_rel < BRIDGE_INT8_REL:
                raise AssertionError(f"int8 relative error {int8_rel}")
            times["int8"] = _time_ms(torch, lambda: bridge.allreduce(
                rdd, compression="int8"), reps=20)
            t0 = time.perf_counter()
            for _ in range(5):
                TorchBridge.driver_reduce(rdd)
            driver_ms = (time.perf_counter() - t0) / 5 * 1e3
            coords = bridge.pmi.kvs().snapshot()
        finally:
            dist.destroy_process_group()
        print(f"  NCCL world 1 on {smi}: quickstart at {QUICKSTART_N:,} "
              f"floats, buffer[-1] 5.0 on both paths, buffers equal "
              f"({quick_s:.3f} s with the first collective); PMI coords "
              f"{coords}; all-reduce of 8 MB (CUDA events): sum "
              f"{times['sum']:.4f} ms, max {times['max']:.4f} ms, mean "
              f"{times['mean']:.4f} ms (each exact), int8 "
              f"{times['int8']:.4f} ms (rel. error {int8_rel:.4g} < "
              f"{BRIDGE_INT8_REL}); the driver path (to the host, numpy) "
              f"{driver_ms:.3f} ms", flush=True)

        t0 = time.perf_counter()
        ranks = _spawn_group(GROUP_WORLD, Path(tmp), dev)
        spawn_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED + 16)
    parts = [rng.standard_normal(QUICKSTART_N).astype(np.float32)
             for _ in range(GROUP_WORLD)]
    want = {"sum": np.sum(parts, 0), "max": np.max(parts, 0),
            "mean": np.mean(parts, 0)}
    for r, out in enumerate(ranks):
        for op, w in want.items():
            np.testing.assert_allclose(out[op], w, rtol=1e-5, atol=1e-4)
        rel = float(np.linalg.norm(out["int8"] - want["sum"])
                    / np.linalg.norm(want["sum"]))
        if not rel < BRIDGE_INT8_REL:
            raise AssertionError(f"rank {r}: int8 relative error {rel}")
        if out["coords"] != {f"coords/{i}": str(dev)
                             for i in range(GROUP_WORLD)}:
            raise AssertionError(f"rank {r}: PMI coords {out['coords']}")
    print(f"  gloo, {GROUP_WORLD} processes on the card ({spawn_s:.1f} s "
          f"with their start): sum, max and mean of {QUICKSTART_N:,} floats "
          f"match numpy (rtol 1e-5, atol 1e-4), int8 within "
          f"{BRIDGE_INT8_REL}; rank 0 (CUDA events) sum "
          f"{ranks[0]['sum_ms']:.3f} ms, max {ranks[0]['max_ms']:.3f} ms, "
          f"mean {ranks[0]['mean_ms']:.3f} ms, int8 "
          f"{ranks[0]['int8_ms']:.3f} ms", flush=True)

    psi, mags, pos, probe, shape = _ptycho_frames(dev, F)
    one = _raar_chain(psi, mags, pos, probe, shape, GROUP_ITERS)
    got = {"psi": np.concatenate([r["psi"] for r in ranks]),
           "obj": ranks[0]["obj"], "probe": ranks[0]["probe"],
           "err": np.float32(ranks[0]["err"])}
    rels = {k: _rel(torch, got[k], one[i].cpu())
            for i, k in enumerate(("psi", "obj", "probe", "err"))}
    diffs = {k: float(np.abs(got[k] - one[i].cpu().numpy()).max())
             for i, k in enumerate(("psi", "obj", "probe", "err"))}
    expect = {"modulus_project": GROUP_ITERS, "raar_combine": GROUP_ITERS,
              "overlap_products": 2 * GROUP_ITERS - 2, "art_sweep": 0,
              "flash_attention": 0}
    for r, out in enumerate(ranks):
        print(f"  rank {r}: frames [{r * F // GROUP_WORLD}, "
              f"{(r + 1) * F // GROUP_WORLD}), {GROUP_ITERS} raar_steps with "
              f"group= in {out['raar_s']:.3f} s, launches {out['launches']}",
              flush=True)
        if out["launches"] != expect:
            raise AssertionError(f"rank {r} launches {out['launches']} != "
                                 f"{expect}")
        for k in ("obj", "probe"):
            if not np.array_equal(out[k], ranks[0][k]):
                raise AssertionError(f"rank {r}'s {k} differs from rank 0's")
    print(f"  the 2-rank chain against one process on the same {F} frames: "
          f"rel. difference (L2) {rels}, max |diff| {diffs} (tol "
          f"{GROUP_REL}); fourier error {ranks[0]['err']:.6f} vs "
          f"{float(one[3]):.6f}", flush=True)
    if not all(math.isfinite(v) and v <= GROUP_REL for v in rels.values()):
        raise AssertionError(f"2-rank RAAR differs from one process: {rels}")
    return {name: [out["launches"][name] for out in ranks]
            for name in ("modulus_project", "overlap_products",
                         "raar_combine")}


def elastic_phase(torch, dev, smi: str) -> dict:
    """Phase 17: the §III stream with ``--elastic`` at Table II size."""
    from repro_torch import kernels
    from repro_torch.apps.ptycho.stream import (ELASTIC_WORKERS, parse_args,
                                                run_stream)

    args = parse_args(ELASTIC_ARGS + ["--out", str(OUT / "elastic")])
    kernels.reset_launch_counts()
    res = run_stream(args, device=dev)
    counts = kernels.launch_counts()
    el = res["elastic"]
    steps = res["iterations"]
    expect = {"modulus_project": steps, "raar_combine": steps,
              "overlap_products": 2 * steps - min(steps, 2),
              "art_sweep": 0, "flash_attention": 0}
    events = [(e.generation, e.world, e.reason) for e in el["events"]]
    print(f"  {res['report'].records} frames in {res['report'].batches} "
          f"batches; worlds after each batch {el['worlds']}; scale events "
          f"{events}; bridges handed to the pipeline (world) "
          f"{el['handed']}; peak lag {el['peak_lag']} (bound "
          f"{el['max_pending'] + el['poll_batch']}), {el['shed']} shed; "
          f"launches {counts}", flush=True)
    print(f"  elastic stream on {smi}: stream {res['stream_time']:.3f} s, "
          f"total {res['total_time']:.3f} s vs acquisition window "
          f"{res['acquisition_window']:.1f} s -> near-real-time "
          f"{res['near_real_time']}; final error {res['final_error']:.4f} "
          f"(<= {MAX_FINAL_ERROR}), quality {res['quality']:.4f} "
          f"(>= {MIN_QUALITY})", flush=True)
    if not (res["report"].records == F and res["frames_seen"][-1] == F):
        raise AssertionError(f"{res['report'].records} records, frames seen "
                             f"{res['frames_seen']}")
    if not (res["final_error"] <= MAX_FINAL_ERROR
            and res["quality"] >= MIN_QUALITY):
        raise AssertionError(f"error {res['final_error']}, quality "
                             f"{res['quality']}")
    if not el["observations"] == res["report"].batches == len(el["worlds"]):
        raise AssertionError(f"{el['observations']} policy observations for "
                             f"{res['report'].batches} batches")
    if not all(1 <= w <= ELASTIC_WORKERS for w in el["worlds"]):
        raise AssertionError(f"world outside [1, {ELASTIC_WORKERS}]: "
                             f"{el['worlds']}")
    if el["handed"] != [e.world for e in el["events"]]:
        raise AssertionError(f"bridges handed {el['handed']} for events "
                             f"{events}")
    if not el["peak_lag"] <= el["max_pending"] + el["poll_batch"]:
        raise AssertionError(f"peak lag {el['peak_lag']}")
    if counts != expect or res["launches"] != expect:
        raise AssertionError(f"launches {counts} != {expect}")
    return counts


def recovery_phase(torch, dev, smi: str) -> dict:
    """Phase 18: ``run_with_recovery`` over 12 RAAR steps on 4 worker slots
    of the card, a checkpoint every 4 steps, one worker failed before step
    6; the state read back bit-equal to what was saved, and the final
    object held to an uncrashed run."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.apps.ptycho.solver import SolverConfig, raar_step
    from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                        restore, save)
    from repro_torch.core.fault import ElasticController, run_with_recovery

    psi0, mags, pos, probe0, shape = _ptycho_frames(dev, F)
    pos = torch.as_tensor(pos, device=dev)
    cfg = SolverConfig()
    root = OUT / "recovery"
    shutil.rmtree(root, ignore_errors=True)
    saved: dict[int, dict] = {}
    steps_run: list[tuple[int, int]] = []
    save_s, restore_s, restored_equal = [], [], []

    def init_state(bridge):
        return {"psi": psi0.clone(), "probe": probe0.clone(),
                "obj": torch.zeros(shape, dtype=torch.complex64, device=dev)}

    def advance(state, step):
        psi, obj, probe, _ = raar_step(state["psi"], mags, pos,
                                       state["probe"], shape, cfg, step)
        return {"psi": psi, "probe": probe, "obj": obj}

    def step_fn(bridge, state, step):
        steps_run.append((step, bridge.world))
        return advance(state, step)

    def save_fn(state, step):
        t0 = time.perf_counter()
        save(str(root), step, state)
        save_s.append(time.perf_counter() - t0)
        saved[step] = {k: v.cpu() for k, v in state.items()}

    def restore_fn(bridge):
        like = {k: torch.empty(0) for k in ("psi", "probe", "obj")}
        t0 = time.perf_counter()
        state, step = restore(str(root), like, device=bridge.device)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
        restored_equal.append(all(
            torch.equal(state[k].cpu(), saved[step][k]) for k in state))
        return state, step

    controller = ElasticController(num_workers=RECOVERY_SLOTS,
                                   devices=[dev] * RECOVERY_SLOTS)
    kernels.reset_launch_counts()
    state, events = run_with_recovery(
        controller, init_state, step_fn, RECOVERY_STEPS, save_fn,
        restore_fn, checkpoint_every=RECOVERY_EVERY,
        failure_plan=dict(RECOVERY_FAILURES))
    counts = kernels.launch_counts()
    uncrashed = init_state(None)
    for step in range(RECOVERY_STEPS):
        uncrashed = advance(uncrashed, step)
    rel = _rel(torch, state["obj"].cpu(), uncrashed["obj"].cpu())
    leaf_bytes = sum(v.numel() * v.element_size() for v in state.values())
    last = root / f"step_{latest_step(str(root)):08d}"
    disk = sum(f.stat().st_size for f in last.iterdir())
    print(f"  steps run (step, world): {steps_run}; events "
          f"{[(e.generation, e.world, e.reason, e.step) for e in events]}; "
          f"launches {counts}", flush=True)
    rerun = [s for s, w in steps_run if w == RECOVERY_SLOTS - 1]
    if not (controller.world == RECOVERY_SLOTS - 1 and len(events) == 1
            and rerun[:2] == [4, 5]
            and [s for s, _ in steps_run].count(4) == 2):
        raise AssertionError(f"recovery ran {steps_run}, events {events}")
    for step in sorted(saved):             # every checkpoint, read back
        like = {k: torch.empty(0) for k in saved[step]}
        back, _ = restore(str(root), like, step=step, device=dev)
        restored_equal.append(all(torch.equal(back[k].cpu(), v)
                                  for k, v in saved[step].items()))
    if not (len(restored_equal) == len(saved) + 1 and all(restored_equal)):
        raise AssertionError(f"restored state bit-equal: {restored_equal}")
    if not rel <= RECOVERY_REL:
        raise AssertionError(f"final object rel. difference {rel} > "
                             f"{RECOVERY_REL}")
    n_steps = len(steps_run)
    expect = {"modulus_project": n_steps, "raar_combine": n_steps,
              "overlap_products": 2 * n_steps - sum(
                  1 for s, _ in steps_run if s < 2),
              "art_sweep": 0, "flash_attention": 0}
    if counts != expect:
        raise AssertionError(f"launches {counts} != {expect}")

    ck = AsyncCheckpointer(str(root / "async"), keep=2)
    t0 = time.perf_counter()
    for step in (4, 8, 12):
        ck.save(step, state)
    ck.wait()
    async_s = time.perf_counter() - t0
    kept = sorted(p.name for p in (root / "async").iterdir()
                  if p.name.startswith("step_"))
    back, step = restore(str(root / "async"), state, device=dev)
    if kept != ["step_00000008", "step_00000012"] or step != 12 or not all(
            torch.equal(back[k], state[k]) for k in state):
        raise AssertionError(f"async checkpointer kept {kept}, step {step}")
    print(f"  recovery OK on {smi}: steps 4-5 re-ran at world "
          f"{RECOVERY_SLOTS - 1}; the recovery's restore and each of "
          f"steps {sorted(saved)} read back bit-equal; final object rel. difference (L2) {rel:.3g} from "
          f"the uncrashed {RECOVERY_STEPS}-step run (tol {RECOVERY_REL}); "
          f"state {leaf_bytes / 2**20:.2f} MiB, {disk / 2**20:.2f} MiB on "
          f"disk a checkpoint; save (card to disk, fsynced) "
          f"{[round(s, 4) for s in save_s]} s, restore (disk to card) "
          f"{[round(s, 4) for s in restore_s]} s; AsyncCheckpointer 3 saves "
          f"(keep 2) {async_s:.4f} s, kept {kept}", flush=True)
    return counts


# phase 25: llava-next-34b, served at full width and full depth; its fp32
# invariant at a stated layer cut (the full depth in fp32 would need 137.6
# GB)
VLM_ARCH = "llava-next-34b"
VLM_PARAMS = 34_388_917_248     # the reference's init, by jax.eval_shape
VLM_PROMPT, VLM_GEN = 1024, 16
VLM_SERVE_ARGS = ["--arch", VLM_ARCH, "--requests", "8", "--batch", "4",
                  "--prompt-len", str(VLM_PROMPT), "--gen", str(VLM_GEN),
                  "--seed", str(SEED)]
VLM_INVARIANT_LAYERS = 8
VLM_INVARIANT_PARAMS = 5_380_365_312    # 8 layers at full width
VLM_INVARIANT_B, VLM_INVARIANT_PROMPT, VLM_INVARIANT_STEPS = 2, 256, 8


def _vlm_requests(torch, dev, config, rng, n: int, prompt_len: int):
    """``n`` requests drawn from ``rng`` as ``run_serve`` draws them (each
    prompt, then its image embeddings): tokens (n, S) and fp32 image
    embeddings (n, num_image_tokens, d_model) on the card."""
    import numpy as np

    prompts, images = [], []
    for _ in range(n):
        prompts.append(rng.integers(0, config.vocab_size, (prompt_len,),
                                    dtype=np.int32))
        images.append(rng.standard_normal(
            (config.num_image_tokens, config.d_model)).astype(np.float32))
    return (torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev),
            torch.from_numpy(np.stack(images)).to(dev))


def vlm_prefill_check(torch, dev, config, params, tokens, images) -> None:
    """The bf16 prefill of ``tokens`` behind ``images`` (the first served
    batch's requests) with the kernel: every launch on the wgmma kernel at
    hd 128, one a layer, timed; then at B 1 over the whole sequence, the
    kernel's last-token logits against the naive attention's, within
    MAX_PREFILL_LOGIT_DIFF (at B 4 the naive scores, (4, 56, S, S) fp32,
    would not fit beside the weights several times over)."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer

    batch = {"tokens": tokens, "image_embeds": images}
    S = tokens.shape[1] + images.shape[1]
    naive = config.replace(attention_impl="naive")
    one = {"tokens": tokens[:1], "image_embeds": images[:1]}
    with torch.inference_mode():
        kernels.reset_launch_counts()
        lk, _ = transformer.prefill(params, batch, config)
        by_instance = _launched(fk.flash_attention.launches_by_instance)
        ms_k = _time_ms(torch, lambda: transformer.prefill(
            params, batch, config), reps=2, warmup=0)
        l1k, _ = transformer.prefill(params, one, config)
        l1n, _ = transformer.prefill(params, one, naive)
        ms_1k = _time_ms(torch, lambda: transformer.prefill(
            params, one, config), reps=2, warmup=0)
        ms_1n = _time_ms(torch, lambda: transformer.prefill(
            params, one, naive), reps=2, warmup=0)
    if not (torch.isfinite(lk).all() and torch.isfinite(l1k).all()
            and torch.isfinite(l1n).all()):
        raise AssertionError("non-finite prefill logits")
    if lk.shape != (tokens.shape[0], 1, config.vocab_size):
        raise AssertionError(f"logits shape {tuple(lk.shape)}")
    diff = _max_err(torch, l1k.float(), l1n.float())
    print(f"  bf16 prefill of {tokens.shape[0]} x {S} positions "
          f"({images.shape[1]} image + {tokens.shape[1]} text) with the "
          f"kernel: {ms_k:.2f} ms, launches {by_instance}; at B 1: kernel "
          f"{ms_1k:.2f} ms, naive {ms_1n:.2f} ms, last-token logits "
          f"max|diff| {diff:.4g} (limit {MAX_PREFILL_LOGIT_DIFF}; max|logit| "
          f"{float(l1n.float().abs().max()):.3g}), greedy token equal "
          f"{bool((l1k.argmax(-1) == l1n.argmax(-1)).all())}", flush=True)
    want = {("wgmma", config.resolved_head_dim): config.num_layers}
    if by_instance != want:
        raise AssertionError(f"flash launches {by_instance} in a bf16 "
                             f"prefill of {config.num_layers} layers, "
                             f"expected {want}")
    if not diff <= MAX_PREFILL_LOGIT_DIFF:
        raise AssertionError(f"kernel and naive prefill logits differ by "
                             f"{diff} > {MAX_PREFILL_LOGIT_DIFF}")


def vlm_invariant(torch, dev, config) -> dict:
    """The serve invariant in full fp32 at full width, cut to
    VLM_INVARIANT_LAYERS layers (the full depth in fp32 would need 137.6
    GB): greedy prefill of VLM_INVARIANT_PROMPT tokens behind a request's
    image embeddings and decode steps equal the argmax of teacher-forced
    prefills behind the same images, VLM_INVARIANT_STEPS tokens, every
    prefill's attention on the tf32x3 kernel at hd 128; on fp32 parameters
    drawn here and released before it returns. Returns the flash launches
    by instance."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 products would run in TF32")
    config = config.replace(num_layers=VLM_INVARIANT_LAYERS, dtype="float32",
                            param_dtype="float32")
    params = _draw(torch, dev, config)
    if _param_count(params) != VLM_INVARIANT_PARAMS:
        raise AssertionError(f"{_param_count(params)} parameters at "
                             f"{VLM_INVARIANT_LAYERS} layers, expected "
                             f"{VLM_INVARIANT_PARAMS}")
    B, S, G = VLM_INVARIANT_B, VLM_INVARIANT_PROMPT, VLM_INVARIANT_STEPS
    tokens, images = _vlm_requests(torch, dev, config,
                                   np.random.default_rng(SEED + 3), B, S)
    n_img = images.shape[1]
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        logits, cache = transformer.prefill(
            params, {"tokens": tokens, "image_embeds": images}, config,
            max_len=n_img + S + G)
        steps = [logits[:, -1]]
        for _ in range(G - 1):
            logits, cache = transformer.decode_step(
                params, steps[-1].argmax(-1)[:, None], cache, config)
            steps.append(logits[:, -1])
        serve = [step.argmax(-1) for step in steps]
        full, worst = tokens, 0.0
        for g in range(G):
            forced, _ = transformer.prefill(
                params, {"tokens": full, "image_embeds": images}, config,
                max_len=n_img + full.shape[1] + 1)
            worst = max(worst, _max_err(torch, forced[:, -1], steps[g]))
            nxt = forced[:, -1].argmax(-1)
            if not torch.equal(nxt, serve[g]):
                raise AssertionError(f"fp32 serve invariant broken at step "
                                     f"{g}: {nxt.tolist()} != "
                                     f"{serve[g].tolist()}")
            full = torch.cat([full, nxt[:, None]], dim=1)
    by_instance = dict(fk.flash_attention.launches_by_instance)
    want = {("tf32x3", config.resolved_head_dim): (1 + G) * config.num_layers}
    print(f"  fp32 serve invariant at full width, {config.num_layers} layers "
          f"({_param_count(params):,} parameters; B {B}, {n_img} image + {S} "
          f"text positions, {G} tokens, launches {_launched(by_instance)}): "
          f"greedy prefill + decode == teacher-forced prefills, tokens "
          f"{torch.stack(serve, 1).tolist()}; reported: max |logit| "
          f"difference, each step against its teacher-forced prefill, "
          f"{worst:.3g}; in {time.perf_counter() - t0:.2f} s", flush=True)
    if _launched(by_instance) != want:
        raise AssertionError(f"flash launches {_launched(by_instance)} in "
                             f"{1 + G} fp32 prefills, expected {want}")
    del params, cache, logits, forced
    torch.cuda.empty_cache()
    return by_instance


def vlm_phase(torch, dev, smi: str) -> dict:
    """Phase 25: llava-next-34b at full width and full depth (60 layers,
    d_model 7,168, 56/8 heads of hd 128, d_ff 20,480, vocabulary 64,000,
    576 image embeddings a request), drawn from the seed in bf16 on a card
    that earlier phases left empty: the prefill check on the first served
    batch's requests (``vlm_prefill_check``), the serve stream through
    ``run_serve`` (VLM_SERVE_ARGS, every request with its image
    embeddings; every flash launch on the wgmma kernel at hd 128, one a
    layer a batch), the first batch's tokens against the model's own loop,
    then the fp32 serve invariant at VLM_INVARIANT_LAYERS layers on fp32
    parameters drawn after the bf16 ones left. Returns the flash launches
    by instance of the serve stream ("served") and of the invariant
    ("invariant")."""
    import gc

    import numpy as np

    from repro_torch.apps.tomo.solver import clear_system_cache
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_args

    t_phase = time.perf_counter()
    gc.collect()
    clear_system_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    free, total = torch.cuda.mem_get_info(dev)
    print(f"  before the draw: {torch.cuda.memory_allocated(dev) / 1e9:.3f} "
          f"GB allocated by this process, {free / 1e9:.2f} GB free of "
          f"{total / 1e9:.2f} GB", flush=True)
    config = get_config(VLM_ARCH)
    params = _draw(torch, dev, config)
    if _param_count(params) != VLM_PARAMS:
        raise AssertionError(f"{_param_count(params)} parameters, the "
                             f"reference's init has {VLM_PARAMS}")
    args = parse_args(VLM_SERVE_ARGS)
    tokens, images = _vlm_requests(torch, dev, config,
                                   np.random.default_rng(args.seed),
                                   args.batch, args.prompt_len)
    vlm_prefill_check(torch, dev, config, params, tokens, images)
    results, res = {}, {}
    served = serve_phase(torch, dev, VLM_SERVE_ARGS, params=params,
                         results=results, served=res)
    gen = args.gen
    print(f"  {VLM_ARCH}: a decode step (ms) by batch "
          f"{[round(1e3 * x / (gen - 1), 2) for x in res['decode_s']]}, "
          f"time to first token (s) {[round(x, 4) for x in res['ttft_s']]},"
          f" {res['tokens_per_s']:.1f} tokens/s; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)
    # run_serve's first batch holds the prefill check's requests
    direct, _ = _greedy(torch, params, config, tokens, gen, images=images)
    served0 = torch.tensor([results[i] for i in range(args.batch)])
    print(f"  batch 0's tokens against the model's own prefill/decode_step "
          f"loop behind the same images: "
          f"{int((direct == served0).all(1).sum())}/{args.batch} requests "
          f"equal", flush=True)
    if not torch.equal(direct, served0):
        raise AssertionError(f"served {served0.tolist()} != the direct loop "
                             f"{direct.tolist()}")
    peak_bf16 = torch.cuda.max_memory_allocated(dev) / 1e9
    del params
    torch.cuda.empty_cache()
    invariant = vlm_invariant(torch, dev, config)
    print(f"  {VLM_ARCH} at full width and depth OK: flash launches served "
          f"{_launched(served)}, in the fp32 invariant {_launched(invariant)};"
          f" peak device memory {peak_bf16:.2f} GB in bf16; "
          f"{time.perf_counter() - t_phase:.1f} s, on {smi}", flush=True)
    return {"served": served, "invariant": invariant}


# phase 26: training. (a) each family's train step at reduced() in fp32,
# card against CPU; (b) internlm2-1.8b at full width; (c) bit-exact resume
# in a child process (deterministic cuBLAS needs its workspace set before
# its first call); (d) the CLI with --resume
TRAIN_FAMILIES = ("internlm2-1.8b", "granite-moe-3b-a800m", "rwkv6-7b",
                  "recurrentgemma-2b", "whisper-medium", "llava-next-34b")
TRAIN_PARITY_B, TRAIN_PARITY_S, TRAIN_PARITY_STEPS = 2, 32, 5
TRAIN_GRAD_TOL = 1e-4           # of each leaf's largest magnitude
TRAIN_LOSS_RTOL = 1e-5
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_PARAMS = 1_889_110_016
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 12
TRAIN_MIN_DROP = 0.3            # tests/test_training.py:32
TRAIN_STREAM_ARGS = ["--arch", TRAIN_ARCH, "--batch", "4", "--seq", "1024",
                     "--steps", "8", "--seed", str(SEED)]
ATTENTION_PART = "blocked attention"
TRAIN_PARTS = {ATTENTION_PART: ("attention", "blocked_attention"),
               "AdamW update": ("repro_torch.training", "adamw_update")}
TRAIN_CLI = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "4", "--batch",
             "2", "--seq", "32", "--ckpt-every", "2"]


def _opt_config(**kw):
    from repro_torch.configs.base import OptimizerConfig

    return OptimizerConfig(**{**dict(lr=1e-3, warmup_steps=2, total_steps=40,
                                     zero1=False), **kw})


def _train_batch(torch, config, rng, b: int, s: int, dev) -> dict:
    """Tokens and the family's fp32 stub embeddings drawn from ``rng``."""
    import numpy as np

    batch = {"tokens": torch.from_numpy(rng.integers(
        0, config.vocab_size, (b, s)).astype(np.int64)).to(dev)}
    if config.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, config.num_image_tokens, config.d_model)).astype(
                np.float32)).to(dev)
    if config.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, config.encoder_seq, config.d_model)).astype(
                np.float32)).to(dev)
    return batch


def train_parity(torch, dev) -> None:
    """(a) Each family's train step at reduced() in fp32 on the card
    against the same step on the CPU, from the same weights over the same
    batches: the step-1 gradients within TRAIN_GRAD_TOL of each leaf's
    largest magnitude, the losses of TRAIN_PARITY_STEPS steps within
    TRAIN_LOSS_RTOL relative. granite-moe runs at capacity factor E/k, so
    that no slot drops (which slots drop depends on routing decisions that
    round-off can flip)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.optim import init_opt_state
    from repro_torch.training import build_train_step, loss_and_grads
    from repro_torch.utils import tree_leaves, tree_map

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 products would run in TF32")
    opt = _opt_config()
    for arch in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        config = get_config(arch, reduced=True).replace(
            dtype="float32", param_dtype="float32", attention_impl="naive")
        if config.num_experts:
            config = config.replace(capacity_factor=config.num_experts
                                    / config.experts_per_token)
        params = get_model(config).init(
            torch.Generator().manual_seed(SEED), config)
        rng = np.random.default_rng(SEED)
        batches = [_train_batch(torch, config, rng, TRAIN_PARITY_B,
                                TRAIN_PARITY_S, "cpu")
                   for _ in range(TRAIN_PARITY_STEPS)]

        def to(tree, d):
            return tree_map(lambda t: t.to(d, copy=True), tree)

        _, _, g_cpu = loss_and_grads(params, batches[0], config)
        _, _, g_dev = loss_and_grads(to(params, dev), to(batches[0], dev),
                                     config)
        worst = 0.0
        for a, b in zip(tree_leaves(g_cpu), tree_leaves(g_dev)):
            scale = float(a.abs().max())
            err = float((b.cpu() - a).abs().max())
            if not np.isfinite(err):
                raise AssertionError(f"{arch}: non-finite gradient")
            worst = max(worst, err / scale if scale else err)
        losses = {}
        for d in ("cpu", dev):
            state = {"params": to(params, d)}
            state["opt"] = init_opt_state(state["params"], opt)
            step = build_train_step(config, opt)
            losses[d] = [float(step(state, to(b, d))[1]["loss"])
                         for b in batches]
        rel = max(abs(x - y) / abs(x)
                  for x, y in zip(losses["cpu"], losses[dev]))
        print(f"  (a) {arch} reduced(), fp32: step-1 gradients card "
              f"against CPU, worst leaf {worst:.3g} of its largest magnitude"
              f" (limit {TRAIN_GRAD_TOL}); {TRAIN_PARITY_STEPS} losses card "
              f"{[round(x, 6) for x in losses[dev]]}, largest relative "
              f"difference from the CPU's {rel:.3g} (limit "
              f"{TRAIN_LOSS_RTOL}); {time.perf_counter() - t0:.1f} s",
              flush=True)
        if not worst <= TRAIN_GRAD_TOL:
            raise AssertionError(f"{arch}: gradients differ by {worst} of a "
                                 f"leaf's largest magnitude")
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"{arch}: losses {losses[dev]} against the "
                                 f"CPU's {losses['cpu']}")


def _attention_ops(torch, prof) -> set:
    """(thread, sequence number) of every operation that ran inside an
    ATTENTION_PART span, recomputed ones included: the keys by which the
    backward nodes of those operations name their forward op."""
    cpu = torch.autograd.DeviceType.CPU
    seen = set()
    for ev in prof.events():
        if ev.device_type != cpu or ev.sequence_nr < 0:
            continue
        up = ev.cpu_parent
        while up is not None:
            if up.name == ATTENTION_PART:
                seen.add((ev.thread, ev.sequence_nr))
                break
            up = up.cpu_parent
    return seen


def _train_part(ev, attention_ops: set) -> str | None:
    """The part of the step a kernel's launching operation ``ev`` belongs
    to, from it and its callers, innermost first: the nearest label
    decides, and the nearest backward node, if it comes first, gives its
    work to the attention when its forward op ran in the attention
    (``_attention_ops``) and to no part otherwise, so that a block
    recomputed in a backward node is not charged to that node."""
    up = ev
    while up is not None:
        if up.name in TRAIN_PARTS:
            return up.name
        if up.name.startswith("autograd::engine::evaluate_function"):
            key = (up.fwd_thread, up.sequence_nr)
            return ATTENTION_PART if key in attention_ops else None
        up = up.cpu_parent
    return None


def _train_split(torch, prof) -> tuple[float, dict]:
    """A profiled step's device time in ms, and its kernels' time by part:
    the blocked attention (its forward, recomputed or not, and the
    backward nodes of its operations), the AdamW update, the GEMMs
    elsewhere, the rest."""
    cpu = torch.autograd.DeviceType.CPU
    part = {ATTENTION_PART: 0.0, "AdamW update": 0.0, "GEMMs": 0.0,
            "the rest": 0.0}
    attention_ops = _attention_ops(torch, prof)
    for ev in prof.events():
        if ev.device_type != cpu or not ev.kernels:
            continue
        label = _train_part(ev, attention_ops)
        for k in ev.kernels:
            ms = k.duration / 1e3
            if label is not None:
                part[label] += ms
            elif any(m in k.name.lower() for m in GEMM_MARKERS):
                part["GEMMs"] += ms
            else:
                part["the rest"] += ms
    return sum(part.values()), part


def _profiled_step(torch, step, state: dict, batch: dict) -> dict:
    """One train step under the profiler, its split by ``_train_split``
    printed with its idle share against the step's wall time (the host
    clock around work that ends in reading the loss). Returns the state."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with _labelled(TRAIN_PARTS), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    busy, part = _train_split(torch, prof)
    if busy == 0:
        print("      the profiled step's trace came back empty; its device "
              "time not measured", flush=True)
    else:
        print(f"      a profiled step: wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}; "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in part.items()),
              flush=True)
    return state


def train_full_width(torch, dev) -> dict:
    """(b) internlm2-1.8b at full width (24 layers, 2,048 wide; bf16
    parameters, fp32 master, m and v; remat full) from the seed: the
    step-1 gradients finite and non-zero on every leaf; (b1) TRAIN_STEPS
    steps of ``build_train_step`` overfitting one batch of TRAIN_B x
    TRAIN_S tokens with tests/test_training.py's optimizer settings, the
    loss falling by TRAIN_MIN_DROP, every loss and gradient norm finite,
    no flash launch; a profiled step split by ``_train_split`` with its
    idle share; (b2) ``run_train`` on the stream (TRAIN_STREAM_ARGS) with
    its step times, tokens/s and ``realtime_report``; the peak device
    memory of each. Returns the flash launches by instance of (b1) and
    (b2)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.train import parse_args, run_train
    from repro_torch.training import (build_train_step, init_state,
                                      loss_and_grads, train_config)
    from repro_torch.utils import tree_leaves

    config = get_config(TRAIN_ARCH)
    opt = _opt_config()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_state(torch.Generator(device=dev).manual_seed(SEED),
                       config, opt)
    n = _param_count(state["params"])
    print(f"  (b) {TRAIN_ARCH}: {n:,} parameters in {config.param_dtype}, "
          f"fp32 master, m and v, remat {config.remat!r}; state drawn in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the card",
          flush=True)
    if n != TRAIN_PARAMS:
        raise AssertionError(f"{n} parameters, expected {TRAIN_PARAMS}")
    batch = _train_batch(torch, config, np.random.default_rng(SEED + 5),
                         TRAIN_B, TRAIN_S, dev)
    kernels.reset_launch_counts()
    _, _, grads = loss_and_grads(state["params"], batch,
                                 train_config(config))
    flat = tree_leaves(grads)
    zero = sum(1 for g in flat if not float(g.float().abs().max()) > 0)
    finite = all(bool(torch.isfinite(g).all()) for g in flat)
    print(f"      step-1 gradients: {len(flat)} leaves, {zero} all zero, "
          f"finite {finite}", flush=True)
    if zero or not finite:
        raise AssertionError(f"{zero} leaves without a gradient, finite "
                             f"{finite}")
    del grads, flat
    step = build_train_step(config, opt)
    losses, gnorms, times = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        gnorms.append(float(m["grad_norm"]))
    overfit = dict(fk.flash_attention.launches_by_instance)
    tokens = TRAIN_B * TRAIN_S
    print(f"  (b1) {TRAIN_STEPS} steps on one batch of {TRAIN_B} x "
          f"{TRAIN_S} (lr {opt.lr}, warmup {opt.warmup_steps}, total "
          f"{opt.total_steps}): losses {[round(x, 4) for x in losses]}, "
          f"grad norms {[round(x, 3) for x in gnorms]}; step times (s) "
          f"{[round(x, 4) for x in times]}, from the second "
          f"{tokens * (len(times) - 1) / sum(times[1:]):.0f} tokens/s; "
          f"flash launches {_launched(overfit)}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"non-finite losses {losses} or gradient norms "
                             f"{gnorms}")
    if not losses[-1] < losses[0] - TRAIN_MIN_DROP:
        raise AssertionError(f"the loss fell from {losses[0]} to "
                             f"{losses[-1]}, not by {TRAIN_MIN_DROP}")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"kernels launched in training: "
                             f"{kernels.launch_counts()}")
    state = _profiled_step(torch, step, state, batch)
    del state, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    res = run_train(parse_args(TRAIN_STREAM_ARGS), device=dev)
    streamed = dict(fk.flash_attention.launches_by_instance)
    print(f"  (b2) run_train {' '.join(TRAIN_STREAM_ARGS)}: {res['steps']} "
          f"steps, losses {[round(x, 4) for x in res['losses']]}; step "
          f"times (s) {[round(x, 4) for x in res['step_s']]}; "
          f"{res['tokens']} tokens in {res['stream_s']:.3f} s: "
          f"{res['tokens_per_s']:.0f} tokens/s; realtime report "
          f"{res['report']}; launches {res['launches']}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)
    if res["steps"] != 8 or not np.isfinite(res["losses"]).all():
        raise AssertionError(f"run_train: {res['steps']} steps, losses "
                             f"{res['losses']}")
    if any(res["launches"].values()):
        raise AssertionError(f"kernels launched: {res['launches']}")
    del res
    torch.cuda.empty_cache()
    return {i: overfit.get(i, 0) + streamed.get(i, 0) for i in overfit}


def resume_child() -> int:
    """(c), in a child process whose environment sets
    ``CUBLAS_WORKSPACE_CONFIG``: tests/test_training.py's bit-exact resume
    on the card at reduced() under ``torch.use_deterministic_algorithms``:
    10 steps straight against 5, a save, a restore and 5 more; every
    parameter bit-equal. Returns the exit code."""
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.training import build_train_step, init_state
    from repro_torch.utils import tree_leaves

    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    config = get_config(TRAIN_ARCH, reduced=True)
    opt = _opt_config(total_steps=20)
    step = build_train_step(config, opt)
    rng = np.random.default_rng(SEED)
    batches = [_train_batch(torch, config, rng, 4, 48, dev)
               for _ in range(10)]

    def fresh():
        return init_state(torch.Generator(device=dev).manual_seed(SEED),
                          config, opt)

    state_a = fresh()
    for b in batches:
        state_a, _ = step(state_a, b)
    state_b = fresh()
    for b in batches[:5]:
        state_b, _ = step(state_b, b)
    OUT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        save(d, 5, state_b)
        restored, at = restore(d, state_b, device=dev)
    for b in batches[5:]:
        restored, _ = step(restored, b)
    pairs = list(zip(tree_leaves(state_a["params"]),
                     tree_leaves(restored["params"])))
    equal = sum(1 for a, b in pairs if torch.equal(a, b))
    print(f"  (c) bit-exact resume at reduced() under deterministic "
          f"algorithms: restored at step {at}, after 10 steps {equal} of "
          f"{len(pairs)} parameter leaves bit-equal to the uninterrupted "
          f"run's", flush=True)
    return 0 if equal == len(pairs) and at == 5 else 1


def _child_env() -> dict:
    src = str(SRC)
    old = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": src + (os.pathsep + old if old
                                               else ""),
            "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def train_processes(torch) -> None:
    """(c) ``resume_child`` in a child process; (d) the CLI, ``python -m
    repro_torch.launch.train`` (TRAIN_CLI) with a checkpoint directory,
    then again with ``--resume``: each exits 0, the second resumes from
    the first's last checkpoint."""
    sys.path.insert(0, str(SRC))
    from repro_torch.checkpoint import latest_step

    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, "-c",
                         "import sys, chip_smoke; "
                         "sys.exit(chip_smoke.resume_child())"],
                        cwd=ROOT, env=_child_env(), timeout=600).returncode
    if rc != 0:
        raise AssertionError(f"bit-exact resume failed (exit {rc})")
    print(f"      (c) in {time.perf_counter() - t0:.1f} s", flush=True)
    ckpt = OUT / "train_cli"
    shutil.rmtree(ckpt, ignore_errors=True)
    for extra in ([], ["--resume"]):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
             "--ckpt-dir", str(ckpt), *extra], cwd=ROOT, env=_child_env(),
            capture_output=True, text=True, timeout=600)
        lines = [ln for ln in (out.stdout + out.stderr).splitlines()
                 if "step " in ln or "resumed" in ln or "done" in ln]
        print(f"  (d) python -m repro_torch.launch.train "
              f"{' '.join(TRAIN_CLI + extra)}: exit {out.returncode}, "
              f"latest checkpoint {latest_step(str(ckpt))}, in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for ln in lines[-4:]:
            print(f"      {ln}", flush=True)
        if out.returncode != 0:
            raise AssertionError(f"the train CLI exited {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        if extra and not any("resumed from step 4" in ln for ln in lines):
            raise AssertionError("the --resume run did not resume from "
                                 "step 4")
        if (latest_step(str(ckpt)) or 0) < 4:
            raise AssertionError(f"latest checkpoint "
                                 f"{latest_step(str(ckpt))}")


def train_phase(torch, dev, smi: str) -> dict:
    """Phase 26: training on the card ((a)-(d) above). Returns the flash
    launches by instance of the full-width runs (none expected)."""
    t_phase = time.perf_counter()
    train_parity(torch, dev)
    launched = train_full_width(torch, dev)
    train_processes(torch)
    print(f"  training OK: flash launches {_launched(launched)}; "
          f"{time.perf_counter() - t_phase:.1f} s, on {smi}", flush=True)
    return launched


# phase 27: the tiled schedules at full width on internlm2-1.8b: a prefill
# of one train_4k sequence under each attention_impl, and the train step on
# 4 x 4,096 tokens (train_4k's batch of 256, configs/base.py SHAPES, cut to
# 4 for one card)
SCHED_S = 4096
# (c)'s steps a schedule: 3 until phase 31 took the time (its check is
# step 1's loss)
SCHED_TRAIN_B, SCHED_TRAIN_STEPS, SCHED_C_STEPS = 4, 6, 2
SCHED_LOSS_RTOL = 1e-3
# label -> (attention_impl, the _skip_blocks override)
SCHEDULES = {"flash": ("flash", False), "blocked": ("blocked", False),
             "blocked, _skip_blocks": ("blocked", True),
             "triangular": ("triangular", False)}


def _schedule(config, label: str):
    impl, skip = SCHEDULES[label]
    return config.replace(attention_impl=impl, sharding_overrides=(
        {"_skip_blocks": True} if skip else {}))


def _tiles(config, label: str, S: int) -> str:
    """The tiles one causal self-attention call of S positions issues under
    the schedule, and their share of the S x S area."""
    from repro_torch.models import attention

    impl, skip = SCHEDULES[label]
    bq, bkv = config.attention_block_q, config.attention_block_kv
    nq, nk = -(-S // bq), -(-S // bkv)
    if impl == "triangular":
        n = sum(map(len, attention.triangular_tiles(nq, bq, 0)))
        return f"{n} of {nq * nq} tiles of {bq} x {bq}"
    n = sum(map(len, attention.blocked_tiles(nq, nk, bq, bkv, True, 0,
                                             skip)))
    return f"{n} of {nq * nk} tiles of {bq} x {bkv}"


def schedule_prefill(torch, dev, config, params) -> dict:
    """(a) One bf16 prefill of 1 x SCHED_S tokens under each schedule and
    under ``naive``, each timed: the last-token logits within
    MAX_PREFILL_LOGIT_DIFF of naive's; ``flash`` launches the wgmma kernel
    once a layer at hd 128, the others launch nothing. Then, on layer 0's
    own q, k and v from the naive run in fp32, each tiled schedule within
    FLASH_TOL["float32"] of the naive attention, each timed. Returns the
    flash launches by instance of the flash prefill."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import attention, transformer

    rng = np.random.default_rng(SEED + 27)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, config.vocab_size, (1, SCHED_S))).to(dev)}
    naive = config.replace(attention_impl="naive")
    core, layer = attention.attention_core, []

    def first_call(q, k, v, qpos, kpos, cfg, causal=True, window=0):
        if not layer:
            layer.append((q, k, v, qpos, kpos))
        return core(q, k, v, qpos, kpos, cfg, causal, window)

    logits, ms, launched = {}, {}, {}
    with torch.inference_mode():
        attention.attention_core = first_call
        try:
            logits["naive"], _ = transformer.prefill(params, batch, naive)
        finally:
            attention.attention_core = core
        ms["naive"] = _time_ms(torch, lambda: transformer.prefill(
            params, batch, naive), reps=3, warmup=1)
        for label in SCHEDULES:
            cfg = _schedule(config, label)
            kernels.reset_launch_counts()
            logits[label], _ = transformer.prefill(params, batch, cfg)
            launched[label] = _launched(
                fk.flash_attention.launches_by_instance)
            ms[label] = _time_ms(torch, lambda cfg=cfg: transformer.prefill(
                params, batch, cfg), reps=3, warmup=1)
    want = logits.pop("naive")
    if not torch.isfinite(want).all():
        raise AssertionError("non-finite naive prefill logits")
    print(f"  (a) bf16 prefill of 1 x {SCHED_S} tokens: naive "
          f"{ms['naive']:.2f} ms", flush=True)
    for label, got in logits.items():
        diff = _max_err(torch, got.float(), want.float())
        print(f"      {label}: {ms[label]:.2f} ms, flash launches "
              f"{launched[label]}, last-token logits max|diff| from naive "
              f"{diff:.4g} (limit {MAX_PREFILL_LOGIT_DIFF}); tiles a call "
              f"{_tiles(config, label, SCHED_S) if label != 'flash' else '-'}",
              flush=True)
        if not torch.isfinite(got).all() or not diff <= MAX_PREFILL_LOGIT_DIFF:
            raise AssertionError(f"{label}: prefill logits differ from naive "
                                 f"by {diff}")
        expect = ({("wgmma", config.resolved_head_dim): config.num_layers}
                  if label == "flash" else {})
        if launched[label] != expect:
            raise AssertionError(f"{label}: flash launches {launched[label]}"
                                 f", expected {expect}")
    q, k, v, qpos, kpos = (t.float() if t.is_floating_point() else t
                           for t in layer[0])
    bq, bkv = config.attention_block_q, config.attention_block_kv
    fns = {"naive": lambda: attention.naive_attention(q, k, v, qpos, kpos),
           "blocked": lambda: attention.blocked_attention(
               q, k, v, qpos, kpos, True, 0, bq, bkv),
           "blocked, _skip_blocks": lambda: attention.blocked_attention(
               q, k, v, qpos, kpos, True, 0, bq, bkv, skip_blocks=True),
           "triangular": lambda: attention.triangular_attention(
               q, k, v, qpos, kpos, True, 0, bq)}
    tol = FLASH_TOL["float32"]
    with torch.inference_mode():
        ref = fns["naive"]()
        line = []
        for label, fn in fns.items():
            err = _max_err(torch, fn(), ref)
            t = _time_ms(torch, fn, reps=5, warmup=1)
            line.append(f"{label} {t:.2f} ms" + (
                "" if label == "naive" else f" (max|diff| {err:.3g})"))
            if not err <= tol:
                raise AssertionError(f"fp32 {label} differs from naive by "
                                     f"{err} > {tol}")
    print(f"  (a) fp32 on layer 0's own q, k, v {tuple(q.shape)} (tol "
          f"{tol}, max|out| {float(ref.abs().max()):.3g}): "
          + ", ".join(line), flush=True)
    del layer, q, k, v, ref
    return launched["flash"]


def _train_run(torch, dev, config, opt, batch, steps: int) -> dict:
    """``steps`` steps of ``build_train_step`` from the seed's state on one
    repeated batch: losses, gradient norms, step times, peak memory; the
    state is released before it returns unless asked for."""
    from repro_torch import kernels
    from repro_torch.training import build_train_step, init_state

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_state(torch.Generator(device=dev).manual_seed(SEED),
                       config, opt)
    step = build_train_step(config, opt)
    kernels.reset_launch_counts()
    losses, gnorms, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        gnorms.append(float(m["grad_norm"]))
    import numpy as np
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"non-finite losses {losses} or gradient norms "
                             f"{gnorms}")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"kernels launched in training: "
                             f"{kernels.launch_counts()}")
    tokens = batch["tokens"].numel()
    return {"state": state, "step": step, "losses": losses,
            "gnorms": gnorms, "times": times,
            "tokens_per_s": tokens * (steps - 1) / sum(times[1:]),
            "peak": torch.cuda.max_memory_allocated(dev) / 1e9}


def schedule_train(torch, dev, config) -> None:
    """(b) ``build_train_step`` at full width on SCHED_TRAIN_B x SCHED_S
    tokens on the default schedule (``flash``, trained as ``blocked``):
    SCHED_TRAIN_STEPS steps overfitting one batch with phase 26's
    optimizer, the loss falling by TRAIN_MIN_DROP and every loss and
    gradient norm finite; step time, tokens/s, peak memory; a profiled step
    split by ``_train_split`` with its idle share. (c) The same from the
    same state with ``_skip_blocks``, then ``triangular``,
    SCHED_C_STEPS steps each: step 1's loss within SCHED_LOSS_RTOL of
    (b)'s; step times, tokens/s, peak memory and the tiles issued."""
    import numpy as np

    opt = _opt_config()
    batch = {"tokens": torch.from_numpy(np.random.default_rng(
        SEED + 28).integers(0, config.vocab_size,
                            (SCHED_TRAIN_B, SCHED_S))).to(dev)}
    run = _train_run(torch, dev, config, opt, batch, SCHED_TRAIN_STEPS)
    losses = run["losses"]
    print(f"  (b) {SCHED_TRAIN_STEPS} steps of {SCHED_TRAIN_B} x {SCHED_S} "
          f"tokens on {config.attention_impl!r}, trained as 'blocked' (lr "
          f"{opt.lr}, warmup {opt.warmup_steps}): losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 3) for x in run['gnorms']]}; step times (s) "
          f"{[round(x, 4) for x in run['times']]}, from the second "
          f"{run['tokens_per_s']:.0f} tokens/s; peak device memory "
          f"{run['peak']:.2f} GB; tiles a call "
          f"{_tiles(config, 'blocked', SCHED_S)}", flush=True)
    if not losses[-1] < losses[0] - TRAIN_MIN_DROP:
        raise AssertionError(f"the loss fell from {losses[0]} to "
                             f"{losses[-1]}, not by {TRAIN_MIN_DROP}")
    _profiled_step(torch, run.pop("step"), run.pop("state"), batch)
    for label in ("blocked, _skip_blocks", "triangular"):
        c = _train_run(torch, dev, _schedule(config, label), opt, batch,
                       SCHED_C_STEPS)
        del c["state"], c["step"]
        rel = abs(c["losses"][0] - losses[0]) / abs(losses[0])
        print(f"  (c) {label}: losses {[round(x, 4) for x in c['losses']]} "
              f"(step 1 {rel:.3g} from (b)'s, limit {SCHED_LOSS_RTOL}); step "
              f"times (s) {[round(x, 4) for x in c['times']]}, from the "
              f"second {c['tokens_per_s']:.0f} tokens/s; peak device memory "
              f"{c['peak']:.2f} GB; tiles a call "
              f"{_tiles(config, label, SCHED_S)}", flush=True)
        if not rel <= SCHED_LOSS_RTOL:
            raise AssertionError(f"{label}: step 1's loss {c['losses'][0]} "
                                 f"against (b)'s {losses[0]}")
    torch.cuda.empty_cache()


def schedules_phase(torch, dev, smi: str) -> dict:
    """Phase 27: internlm2-1.8b at full width (the reference's config,
    bf16 from the seed) on train_4k's 4,096-token sequences: (a)
    ``schedule_prefill``; (b) and (c) ``schedule_train``. Returns (a)'s
    flash launches by instance."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"  {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated on "
          f"the card before the draw", flush=True)
    config = get_config(ARCH)
    params = _draw(torch, dev, config)
    launched = schedule_prefill(torch, dev, config, params)
    del params
    schedule_train(torch, dev, config)
    print(f"  the schedules at {SCHED_S} tokens OK: flash launches "
          f"{launched}; {time.perf_counter() - t_phase:.1f} s, on {smi}",
          flush=True)
    return launched


# phase 28: the explicit-collective data-parallel trainer (parallel/dp.py),
# in a child process under deterministic algorithms, so that every run
# from one state computes the same gradients: (a) NCCL at world 1 at full
# width, (b) two gloo processes on the card at a cut depth
DP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=50, zero1=False,
              grad_clip=1.0, weight_decay=0.0)      # tests/test_dp.py:17-18
DP_STEPS = 4
DP_LOSS_ATOL = 1e-2                                 # tests/test_dp.py:34-44
DP_RTOL, DP_ATOL = 2e-2, 2e-3
# tests/test_dp.py holds every parameter of the reduced model to these
# bounds; of the 1.89 B at full width a few elements whose gradients are
# within round-off of zero step by +-lr differently in the two runs
# (AdamW's first steps move an element by about lr · sign(g)): a share of
# at most DP_OFF_SHARE may lie outside them, each within DP_PART (two
# trajectories of DP_STEPS AdamW steps of at most lr · 1.002, the largest
# |m_hat / sqrt(v_hat)| at steps 1-4, apart, weight decay 0) plus one bf16
# ulp of the parameter
DP_OFF_SHARE = 1e-6
DP_PART = 2 * DP_STEPS * DP_OPT["lr"] * 1.002
DP_GLOO_WORLD, DP_GLOO_LAYERS = 2, 2
# phase 28 (b)'s steps: cut from DP_STEPS (4) to make room for phase 31;
# the allowance DP_PART stays the 4 steps' that phase 29 (b) also holds
# its 2-step runs to
DP_GLOO_STEPS = 2


def _dp_plain_step(torch, config, opt, compression):
    """The plain version of the DP step, written apart from parallel/dp.py:
    each rank's gradients in turn in this process (one batch a rank),
    reduced by their mean or, with int8, by the reference's codes on one
    shared scale (max |g| over the ranks / 127, rounded, clipped to ±127,
    summed in int32, times scale / W), then the one-process AdamW
    (``adamw_update``; DP_OPT decays nothing, so its per-leaf rule and the
    DP path's flat one agree) on the whole tree. ``step(state, batches)``
    returns (state, the ranks' mean loss)."""
    from repro_torch.optim import adamw_update
    from repro_torch.training import loss_and_grads, train_config
    from repro_torch.utils import tree_leaves, tree_map

    config = train_config(config)

    def step(state, batches):
        losses, grads = [], []
        for b in batches:
            loss, _, g = loss_and_grads(state["params"], b, config)
            losses.append(loss)
            grads.append(g)
        W = len(batches)
        if compression == "int8":
            amax = torch.stack([g.abs().max().float() for tree in grads
                                for g in tree_leaves(tree)]).max()
            scale = torch.clamp(amax / 127.0, min=1e-12)

            def reduce(*gs):
                total = sum(torch.clamp(torch.round(g.float() / scale), -127,
                                        127).to(torch.int32) for g in gs)
                return total.to(torch.float32) * scale / W
        else:
            def reduce(*gs):
                return sum(g.float() for g in gs) / W
        reduced = tree_map(reduce, *grads)
        del grads
        params, opt_state, _ = adamw_update(state["params"], reduced,
                                            state["opt"], opt)
        return ({"params": params, "opt": opt_state},
                torch.stack(losses).mean())

    return step


@contextlib.contextmanager
def _dp_timers(torch):
    """Seconds in the DP step's gradients (``loss_and_grads``) and in its
    collectives (``_Wire``'s methods, with their host staging), each
    between synchronizes."""
    from repro_torch.parallel import dp

    spent = {"compute": 0.0, "collectives": 0.0}
    saved = [(dp, "loss_and_grads", "compute")] + [
        (dp._Wire, name, "collectives") for name in
        ("all_reduce", "reduce_scatter", "all_to_all", "all_gather")]
    originals = [(owner, name, getattr(owner, name))
                 for owner, name, _ in saved]

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return run

    for (owner, name, key), (_, _, fn) in zip(saved, originals):
        setattr(owner, name, timed(fn, key))
    try:
        yield spent
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)


def _dp_run(torch, dev, kind: str, config, opt, batch, group=None,
            compression=None, shares: int = 1, steps: int = DP_STEPS
            ) -> dict:
    """``steps`` steps from the seed's parameters: ``kind`` "one" is the
    one-process ``build_train_step`` on ``batch``; "plain" is
    ``_dp_plain_step`` over ``shares`` equal shares of ``batch``, one a
    rank;
    "dp" is ``build_dp_train_step`` on this rank's share. Returns the
    losses, step times, the DP step's split, peak memory and the final
    parameters on the host."""
    from repro_torch.models.registry import get_model
    from repro_torch.parallel import (build_dp_train_step,
                                      init_dp_opt_state, shard_batch)
    from repro_torch.training import build_train_step, init_state
    from repro_torch.utils import tree_leaves

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if kind == "dp":
        params = get_model(config).init(gen, config)
        state = {"params": params,
                 "opt": init_dp_opt_state(params, group, opt)}
        dp_step = build_dp_train_step(config, opt, group, compression)
        mine = shard_batch(batch, group)

        def step(state):
            state, m = dp_step(state, mine)
            return state, m["loss"]
    else:
        state = init_state(gen, config, opt)
        if kind == "one":
            one_step = build_train_step(config, opt)

            def step(state):
                state, m = one_step(state, batch)
                return state, m["loss"]
        else:
            plain = _dp_plain_step(torch, config, opt, compression)
            n = batch["tokens"].shape[0] // shares
            parts = [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                     for i in range(shares)]

            def step(state):
                return plain(state, parts)
    losses, times = [], []
    with _dp_timers(torch) as spent:
        for i in range(steps):
            if i == 1:                  # a step's split from the second
                first = dict(spent)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, loss = step(state)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
    split = {k: (v - first[k]) / (steps - 1) for k, v in spent.items()}
    return {"losses": losses, "times": times, "split": split,
            "peak": torch.cuda.max_memory_allocated(dev) / 1e9,
            "params": [p.detach().cpu() for p in
                       tree_leaves(state["params"])]}


def _dp_held(torch, dev, got: dict, want: dict) -> dict:
    """Two runs' losses and parameters: the largest loss difference; the
    largest parameter difference; the elements outside rtol DP_RTOL and
    atol DP_ATOL, and their share; the elements farther apart than two
    AdamW trajectories can part (DP_PART) plus one bf16 ulp of the
    parameter."""
    loss = max(abs(a - b) for a, b in zip(got["losses"], want["losses"]))
    worst, bad, beyond, n = 0.0, 0, 0, 0
    for a, b in zip(got["params"], want["params"]):
        a, b = a.to(dev).float(), b.to(dev).float()
        d, mag = (a - b).abs(), b.abs()
        worst = max(worst, float(d.max()))
        bad += int((d > DP_ATOL + DP_RTOL * mag).sum())
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
        beyond += int((d > DP_PART + ulp).sum())
        n += d.numel()
    return {"loss": loss, "worst": worst, "bad": bad, "share": bad / n,
            "beyond": beyond}


def _dp_ok(held: dict) -> bool:
    return (held["loss"] <= DP_LOSS_ATOL and held["share"] <= DP_OFF_SHARE
            and held["beyond"] == 0)


def _dp_report(held: dict) -> str:
    return (f"max |loss diff| {held['loss']:.3g} (limit {DP_LOSS_ATOL}), "
            f"max |param diff| {held['worst']:.3g}, {held['bad']} elements "
            f"outside rtol {DP_RTOL}, atol {DP_ATOL} (a {held['share']:.3g} "
            f"share, limit {DP_OFF_SHARE}), {held['beyond']} beyond two "
            f"AdamW trajectories ({DP_PART:.4g} + one bf16 ulp)")


def _dp_line(label: str, run: dict) -> str:
    steps = run["times"][1:]
    split = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in
                      run["split"].items() if v)
    return (f"{label}: losses {[round(x, 5) for x in run['losses']]}, step "
            f"times (s) {[round(x, 4) for x in run['times']]}, from the "
            f"second {sum(steps) / len(steps) * 1e3:.1f} ms a step"
            + (f" (a step's mean: {split})" if split else "")
            + f"; peak device memory {run['peak']:.2f} GB")


def _dp_check(torch, dev, label: str, got: dict, want: dict,
              held: bool = True) -> bool:
    """Prints how far ``got`` is from ``want``; whether it is within the
    bounds (always True when only reported)."""
    res = _dp_held(torch, dev, got, want)
    print(f"      {label}: {_dp_report(res)}"
          + ("" if held else " (reported)"), flush=True)
    return not held or _dp_ok(res)


def _dp_gloo_rank(rank: int, world: int, init: str, device: str, results,
                  ref_path: str) -> None:
    """One of phase 28 (b)'s processes: the DP step over a gloo group on
    the card at DP_GLOO_LAYERS layers, without and with int8, each held to
    the plain runs in ``ref_path``."""
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    try:
        torch.use_deterministic_algorithms(True)
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        try:
            from repro_torch.configs import get_config
            from repro_torch.configs.base import OptimizerConfig

            ref = torch.load(ref_path)
            config = get_config(TRAIN_ARCH).replace(
                num_layers=DP_GLOO_LAYERS)
            opt = OptimizerConfig(**DP_OPT)
            batch = {"tokens": ref["tokens"].to(dev)}
            out = {}
            for comp in (None, "int8"):
                run = _dp_run(torch, dev, "dp", config, opt, batch,
                              dist.group.WORLD, comp, steps=DP_GLOO_STEPS)
                out[comp] = {"line": _dp_line(f"rank {rank}, "
                                              f"{comp or 'uncompressed'}",
                                              run),
                             "held": _dp_held(torch, dev, run, ref[comp])}
                del run
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def dp_child() -> int:
    """Phase 28, in a child process whose environment sets
    ``CUBLAS_WORKSPACE_CONFIG``, under deterministic algorithms. (a) NCCL
    at world 1 (a group from a ``FileStore``) with internlm2-1.8b at full
    width on TRAIN_B x TRAIN_S tokens with tests/test_dp.py's optimizer:
    DP_STEPS steps of ``build_dp_train_step`` against the one-process
    ``build_train_step`` from the same state, then with int8 against the
    plain int8 step (``_dp_plain_step``), each within tests/test_dp.py's
    bounds (the int8 run's distance from the uncompressed step reported);
    step times split into gradients, collectives and the rest, peak
    memory. (b) DP_GLOO_WORLD spawned processes on the card over gloo at
    DP_GLOO_LAYERS layers (the depth cut), each on its TRAIN_B /
    DP_GLOO_WORLD rows, without and with int8, held to the one-process
    step and the plain int8 step over the same rows at that depth."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig

    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    opt = OptimizerConfig(**DP_OPT)
    config = get_config(TRAIN_ARCH)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 29).integers(
        0, config.vocab_size, (TRAIN_B, TRAIN_S)))
    batch = {"tokens": tokens.to(dev)}
    OUT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
            rank=0, world_size=1, device_id=dev)
        try:
            group = dist.group.WORLD
            runs = {"one": _dp_run(torch, dev, "one", config, opt, batch)}
            runs["dp"] = _dp_run(torch, dev, "dp", config, opt, batch, group)
            runs["dp int8"] = _dp_run(torch, dev, "dp", config, opt, batch,
                                      group, "int8")
        finally:
            dist.destroy_process_group()
        runs["plain int8"] = _dp_run(torch, dev, "plain", config, opt,
                                     batch, compression="int8")
        print(f"  (a) {TRAIN_ARCH} at full width, {TRAIN_B} x {TRAIN_S} "
              f"tokens, {DP_STEPS} steps (lr {opt.lr}, warmup "
              f"{opt.warmup_steps}, weight decay {opt.weight_decay}), NCCL "
              f"world 1, deterministic algorithms:", flush=True)
        for label, run in runs.items():
            print(f"      {_dp_line(label, run)}", flush=True)
        failed = [label for label, a, b, held in (
            ("DP against the one-process step", "dp", "one", True),
            ("DP int8 against the plain int8 step", "dp int8", "plain int8",
             True),
            ("DP int8 against the uncompressed one-process step", "dp int8",
             "one", False))
            if not _dp_check(torch, dev, label, runs[a], runs[b], held)]
        del runs
        torch.cuda.empty_cache()

        config = config.replace(num_layers=DP_GLOO_LAYERS)
        ref = {"tokens": tokens}
        for comp, label in ((None, "the one-process step"),
                            ("int8", "the plain int8 step over the ranks' "
                                     "rows")):
            run = (_dp_run(torch, dev, "one", config, opt, batch,
                           steps=DP_GLOO_STEPS)
                   if comp is None else
                   _dp_run(torch, dev, "plain", config, opt, batch,
                           compression="int8", shares=DP_GLOO_WORLD,
                           steps=DP_GLOO_STEPS))
            ref[comp] = {"losses": run["losses"], "params": run["params"]}
            print(f"  (b) at {DP_GLOO_LAYERS} layers, "
                  f"{_dp_line(label, run)}", flush=True)
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save(ref, ref_path)
        del ref
        t0 = time.perf_counter()
        ranks = _spawn_group(DP_GLOO_WORLD, Path(tmp), dev,
                             target=_dp_gloo_rank, extra=(ref_path,))
        spawn_s = time.perf_counter() - t0
    print(f"  (b) {DP_GLOO_WORLD} gloo processes on the card at "
          f"{DP_GLOO_LAYERS} layers, {TRAIN_B // DP_GLOO_WORLD} rows each, "
          f"{DP_GLOO_STEPS} steps ({spawn_s:.1f} s with their start):",
          flush=True)
    for r, out in enumerate(ranks):
        for comp, res in out.items():
            want = "one-process" if comp is None else "plain int8"
            print(f"      {res['line']}; against the {want} step: "
                  f"{_dp_report(res['held'])}", flush=True)
            if not _dp_ok(res["held"]):
                failed.append(f"rank {r}, {comp or 'uncompressed'}")
    if failed:
        raise AssertionError(f"outside the bounds: {failed}")
    return 0


def dp_phase(torch, dev, smi: str) -> None:
    """Phase 28: ``dp_child`` in a child process (the deterministic
    algorithms need ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts), after
    this process released what it held on the card."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    rc = subprocess.run([sys.executable, "-c",
                         "import sys, chip_smoke; "
                         "sys.exit(chip_smoke.dp_child())"],
                        cwd=ROOT, env=_child_env(), timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"the data-parallel trainer failed (exit {rc})")
    print(f"  the data-parallel trainer OK; "
          f"{time.perf_counter() - t_phase:.1f} s, on {smi}", flush=True)


# phase 29: the mesh (parallel/sharding.py, training.shardings_for, ZeRO-1
# in optim/adamw.py), in a child process under deterministic algorithms as
# phase 28: (a) NCCL at world 1 on a (data 1, model 1) mesh at full width:
# the zero1=True train cell against the one-process step, a prefill cell
# on flash and a decode on a placed cache; (b) two gloo processes on the
# card (their collectives staged through the host) at phase 28's depth
# cut on a ZeRO-1 mesh and a tensor-parallel one
# (a)'s train steps and decode steps: 4 and 8 until phase 31 took the
# time
MESH_STEPS, MESH_GLOO_STEPS, MESH_DECODE = 2, 2, 2
# (label, mesh shape, activation dtype, held to phase 28's rule): under
# tensor parallelism each row-parallel product is two partial sums added
# in the activations' dtype, so in bf16 the gradients part from the
# one-process step's by bf16 round-off and more elements step by +-lr
# differently than phase 28's share allows (reported); in fp32 the rule
# holds the split to fp32 round-off
MESH_GLOO_RUNS = (("ZeRO-1, (data 2, model 1)", (2, 1), "bfloat16", True),
                  ("tensor parallel, (data 1, model 2)", (1, 2), "bfloat16",
                   False),
                  ("tensor parallel, (data 1, model 2), fp32 activations",
                   (1, 2), "float32", True))
MESH_TP = (1, 2)
# (b)'s tokens a row: cut from TRAIN_S (1,024) to make room for phase 31;
# the tensor-parallel steps' host-staged collectives move activations
MESH_GLOO_S = 256
MESH_LAUNCHES = "mesh_launches.json"


def _local_bytes(tree) -> int:
    from repro_torch.parallel.sharding import is_dtensor
    from repro_torch.utils import tree_leaves
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree) if is_dtensor(t))


def _busy_ms(torch, fn) -> tuple[float, float]:
    """(wall ms, device busy ms) of ``fn()`` under the profiler; busy 0
    when the trace comes back empty."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, sum(_device_us(torch, prof).values()) / 1e3


def _mesh_run(torch, dev, config, opt, batch, mesh, steps: int,
              profile: bool = False) -> dict:
    """``steps`` steps of ``build_train_step`` on the cell
    ``shardings_for`` gives ``mesh``, the state drawn from SEED and placed
    by the cell's specs, the batch by its batch specs; the losses, step
    times, this rank's bytes of parameters and optimizer state, the
    seconds in host-staged collectives a step (gloo), peak memory, and the
    gathered parameters on the host. With ``profile`` one more step is
    profiled."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.parallel import sharding
    from repro_torch.training import build_train_step, init_state, \
        shardings_for
    from repro_torch.utils import tree_leaves

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    B, S = batch["tokens"].shape
    cell = shardings_for(config, ShapeConfig("mesh", S, B, "train"), mesh,
                         opt)
    state = cell.place(init_state(torch.Generator(device=dev).manual_seed(
        SEED), config, opt), cell.state_specs)
    placed = cell.place(batch, cell.batch_specs)
    step = build_train_step(config, opt)
    sizes = {"params": _local_bytes(state["params"]),
             "state": _local_bytes({k: state["opt"][k]
                                    for k in ("m", "v", "master")})}
    staged = sharding.host_staged_class()
    losses, times, coll = [], [], []
    with sharding.use_mesh(cell.mesh, cell.rules):
        for _ in range(steps):
            torch.cuda.synchronize(dev)
            c0, t0 = staged.seconds, time.perf_counter()
            state, m = step(state, placed)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
            coll.append(staged.seconds - c0)
        busy = None
        if profile:
            def one():
                nonlocal state
                state, m = step(state, placed)
                float(m["loss"])
            busy = _busy_ms(torch, one)
    later = coll[1:] or coll
    split = ({"host-staged collectives": sum(later) / len(later)}
             if any(coll) else {})
    return {"losses": losses, "times": times, "collectives": coll,
            "split": split, "bytes": sizes, "busy": busy,
            "peak": torch.cuda.max_memory_allocated(dev) / 1e9,
            "params": [p.detach().cpu() for p in tree_leaves(
                sharding.gather_tree(state["params"]))]}


def _mesh_serve(torch, dev, config, params, tokens, mesh, decode: int
                ) -> dict:
    """The prefill cell's (``shardings_for``) prefill of ``tokens`` on
    ``mesh``, the parameters and the batch placed, the cache placed by the
    prefill, then ``decode`` greedy steps; beside it the same on the plain
    parameters. Returns the flash launches by instance and the heads they
    ran on (global, local) in the sharded prefill, both runs' last-token
    logits, greedy tokens and times."""
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import attention
    from repro_torch.parallel.sharding import is_dtensor, use_mesh, whole
    from repro_torch.training import build_serve_fns, shardings_for

    B, S = tokens.shape
    cell = shardings_for(config, ShapeConfig("mesh", S, B, "prefill"), mesh)
    prefill, step = build_serve_fns(config)
    heads, core = set(), attention._local_core

    def counted(q, *args):
        heads.add((q.shape[2], q.to_local().shape[2]))
        return core(q, *args)

    def run(params, batch) -> dict:
        """The prefill twice (the second timed: the first also fills
        DTensor's sharding caches), then the decode, its steps after the
        first timed."""
        out = {}
        with torch.inference_mode():
            prefill(params, batch, S + decode)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            kernels.reset_launch_counts()
            logits, cache = prefill(params, batch, S + decode)
            torch.cuda.synchronize(dev)
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            out["launched"] = _launched(
                fk.flash_attention.launches_by_instance)
            out["logits"] = whole(logits).float()
            toks = []
            for i in range(decode):
                if i == 1:
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                tok = torch.argmax(whole(logits)[:, -1], -1)[:, None]
                toks.append(tok)
                logits, cache = step(params, tok, cache)
            torch.cuda.synchronize(dev)
            out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / max(
                1, decode - 1)
            # plain numbers: a result crosses processes after its sender
            # exits
            out["tokens"] = torch.cat(toks, 1).cpu().tolist()
            out["cache_placed"] = all(
                is_dtensor(t) for t in cache.values()
                if isinstance(t, torch.Tensor))
        return out

    plain = run(params, {"tokens": tokens})
    attention._local_core = counted
    try:
        with use_mesh(cell.mesh, cell.rules):
            got = run(cell.place(params, cell.param_specs),
                      cell.place({"tokens": tokens}, cell.batch_specs))
    finally:
        attention._local_core = core
    got["heads"] = sorted(heads)
    got["diff"] = _max_err(torch, got.pop("logits"), plain.pop("logits"))
    got["same_tokens"] = got["tokens"] == plain["tokens"]
    got["plain"] = plain
    return got


def _serve_line(label: str, got: dict) -> str:
    return (f"{label}: flash {got['launched']} on (global, local) heads "
            f"{got['heads']}, cache placed {got['cache_placed']}; "
            f"last-token logits max|diff| {got['diff']:.4g} from the "
            f"unsharded prefill (limit {MAX_PREFILL_LOGIT_DIFF}); "
            f"{MESH_DECODE} decode steps' tokens equal the unsharded "
            f"run's: {got['same_tokens']}; "
            f"prefill {got['prefill_ms']:.1f} ms (unsharded "
            f"{got['plain']['prefill_ms']:.1f}), a decode step "
            f"{got['decode_ms']:.1f} ms (unsharded "
            f"{got['plain']['decode_ms']:.1f})")


def _mesh_gloo_rank(rank: int, world: int, init: str, device: str,
                    results, ref_path: str) -> None:
    """One of phase 29 (b)'s processes, on the host-staged gloo backend:
    MESH_GLOO_STEPS steps on each of MESH_GLOO_RUNS against the
    one-process step in ``ref_path`` at DP_GLOO_LAYERS layers, then the
    tensor-parallel mesh's prefill on its local heads."""
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    try:
        torch.use_deterministic_algorithms(True)
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        from repro_torch.parallel.sharding import register_host_staged
        dist.init_process_group(register_host_staged(), init_method=init,
                                rank=rank, world_size=world)
        try:
            from torch.distributed.device_mesh import init_device_mesh

            from repro_torch.configs import get_config
            from repro_torch.configs.base import OptimizerConfig
            from repro_torch.models.registry import get_model

            ref = torch.load(ref_path)
            config = get_config(TRAIN_ARCH).replace(
                num_layers=DP_GLOO_LAYERS)
            opt = OptimizerConfig(**{**DP_OPT, "zero1": True})
            batch = {"tokens": ref["tokens"].to(dev)}
            out = {"errors": {}}
            meshes = {}
            for label, shape, dtype, _ in MESH_GLOO_RUNS:
                if shape not in meshes:
                    meshes[shape] = init_device_mesh(
                        "cuda", shape, mesh_dim_names=("data", "model"))
                mesh = meshes[shape]
                try:
                    run = _mesh_run(torch, dev, config.replace(dtype=dtype),
                                    opt, batch, mesh, MESH_GLOO_STEPS)
                    out[label] = {
                        "line": _dp_line(f"rank {rank}, {label}", run),
                        "bytes": run["bytes"], "times": run["times"],
                        "collectives": run["collectives"],
                        "held": _dp_held(torch, dev, run, ref["one"][dtype])}
                    del run
                except Exception:
                    out["errors"][label] = traceback.format_exc()
                torch.cuda.empty_cache()
                if shape == MESH_TP and "tp_serve" not in out:
                    try:
                        params = get_model(config).init(torch.Generator(
                            device=dev).manual_seed(SEED), config)
                        out["tp_serve"] = _mesh_serve(
                            torch, dev, config, params, batch["tokens"], mesh,
                            MESH_DECODE)
                        del params
                    except Exception:
                        out["errors"]["tp_serve"] = traceback.format_exc()
                    torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def _mesh_world1_train(torch, dev, config, batch, mesh) -> list[str]:
    """Phase 29 (a)'s train cell against the one-process step; the
    failures."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.training import build_train_step, init_state

    plain = OptimizerConfig(**DP_OPT)
    one = _dp_run(torch, dev, "one", config, plain, batch, steps=MESH_STEPS)
    state = init_state(torch.Generator(device=dev).manual_seed(SEED), config,
                       plain)
    step = build_train_step(config, plain)

    def one_step():
        nonlocal state
        state, m = step(state, batch)
        float(m["loss"])
    one_step()
    one_busy = _busy_ms(torch, one_step)
    del state, step
    torch.cuda.empty_cache()
    meshed = _mesh_run(torch, dev, config, OptimizerConfig(
        **{**DP_OPT, "zero1": True}), batch, mesh, MESH_STEPS, profile=True)
    print(f"      {_dp_line('one process (zero1=False)', one)}", flush=True)
    print(f"      {_dp_line('the mesh (zero1=True)', meshed)}; this rank's "
          f"parameters {meshed['bytes']['params'] / 1e9:.3f} GB, optimizer "
          f"state {meshed['bytes']['state'] / 1e9:.3f} GB", flush=True)
    (w1, b1), (w2, b2) = one_busy, meshed["busy"]
    print(f"      a profiled step: one process wall {w1:.1f} ms, device busy "
          f"{b1:.1f} ms; the mesh wall {w2:.1f} ms, device busy {b2:.1f} ms: "
          f"DTensor's dispatch {w2 - w1:.1f} ms a step on the host"
          + ("" if b1 and b2 else " (a trace came back empty: device time "
             "not measured)"), flush=True)
    if not _dp_check(torch, dev, "the mesh against the one-process step",
                     meshed, one):
        return ["(a) the mesh's train step"]
    return []


def _mesh_world1_serve(torch, dev, config, batch, mesh
                       ) -> tuple[list[str], dict]:
    """Phase 29 (a)'s prefill cell and decode; the failures and the flash
    launches of the sharded prefill."""
    from repro_torch.models.registry import get_model

    params = get_model(config).init(torch.Generator(device=dev).manual_seed(
        SEED), config)
    served = _mesh_serve(torch, dev, config, params, batch["tokens"], mesh,
                         MESH_DECODE)
    del params
    torch.cuda.empty_cache()
    print(f"      {_serve_line(f'the prefill cell, {TRAIN_B} x {TRAIN_S}', served)}",
          flush=True)
    want = {("wgmma", config.resolved_head_dim): config.num_layers}
    if served["launched"] != want or not served["diff"] <= \
            MAX_PREFILL_LOGIT_DIFF or not served["cache_placed"]:
        return [f"(a) the prefill cell: launches {served['launched']} (want "
                f"{want}), logits {served['diff']}"], served["launched"]
    return [], served["launched"]


def _mesh_gloo(torch, dev, config, tokens, batch, tmp: str
               ) -> tuple[list[str], dict]:
    """Phase 29 (b); the failures and the tensor-parallel prefill's flash
    launches over the ranks."""
    from repro_torch.configs.base import OptimizerConfig

    ref = {"tokens": tokens, "one": {}}
    for dtype in sorted({dtype for _, _, dtype, _ in MESH_GLOO_RUNS}):
        small = config.replace(num_layers=DP_GLOO_LAYERS, dtype=dtype)
        run = _dp_run(torch, dev, "one", small, OptimizerConfig(**DP_OPT),
                      batch, steps=MESH_GLOO_STEPS)
        print(f"  (b) at {DP_GLOO_LAYERS} layers, {dtype} activations, "
              f"{_dp_line('the one-process step', run)}", flush=True)
        ref["one"][dtype] = {"losses": run["losses"],
                             "params": run["params"]}
        del run
        torch.cuda.empty_cache()
    ref_path = os.path.join(tmp, "ref.pt")
    torch.save(ref, ref_path)
    del ref
    t0 = time.perf_counter()
    ranks = _spawn_group(DP_GLOO_WORLD, Path(tmp), dev,
                         target=_mesh_gloo_rank, extra=(ref_path,))
    print(f"  (b) {DP_GLOO_WORLD} gloo processes on the card, collectives "
          f"staged through the host, at {DP_GLOO_LAYERS} layers on "
          f"{tuple(tokens.shape)} tokens ({time.perf_counter() - t0:.1f} s "
          f"with their start):", flush=True)
    failed, launched = [], {}
    for r, out in enumerate(ranks):
        for label in ([r[0] for r in MESH_GLOO_RUNS] + ["tp_serve"]):
            if label in out.get("errors", {}):
                print(f"      rank {r}, {label} failed:\n"
                      f"{out['errors'][label]}", flush=True)
                failed.append(f"(b) rank {r}, {label}")
        for label, _, _, held in MESH_GLOO_RUNS:
            if label not in out:
                continue
            res = out[label]
            steps, coll = res["times"][1:], res["collectives"][1:]
            share = sum(coll) / sum(steps) if steps else 0.0
            print(f"      {res['line']}; this rank's parameters "
                  f"{res['bytes']['params'] / 1e9:.3f} GB, optimizer state "
                  f"{res['bytes']['state'] / 1e9:.3f} GB; collectives "
                  f"{share:.3f} of a step; against the one-process step: "
                  f"{_dp_report(res['held'])}"
                  + ("" if held else " (reported)"), flush=True)
            if held and not _dp_ok(res["held"]):
                failed.append(f"(b) rank {r}, {label}")
        if "tp_serve" not in out:
            continue
        tp = out["tp_serve"]
        print(f"      rank {r}, "
              f"{_serve_line('the tensor-parallel prefill', tp)}",
              flush=True)
        for key, n in tp["launched"].items():
            launched[key] = launched.get(key, 0) + n
        want = {("wgmma", config.resolved_head_dim): DP_GLOO_LAYERS}
        local = config.num_heads // MESH_TP[1]
        if tp["launched"] != want or tp["heads"] != [(config.num_heads,
                                                      local)] or \
                not tp["diff"] <= MAX_PREFILL_LOGIT_DIFF:
            failed.append(f"(b) rank {r}, the tensor-parallel prefill")
    return failed, launched


def mesh_child() -> int:
    """Phase 29, in a child process whose environment sets
    ``CUBLAS_WORKSPACE_CONFIG``, under deterministic algorithms, with
    tests/test_dp.py's optimizer and ``zero1=True`` (the reference's
    default). (a) NCCL at world 1, a (data 1, model 1) mesh, internlm2-1.8b
    at full width on TRAIN_B x TRAIN_S tokens: MESH_STEPS steps of the
    ``shardings_for`` train cell against the one-process ``zero1=False``
    step from the same state, within phase 28's rule; each step's time
    and a profiled step of each, so that the mesh's extra wall time over
    the same device work is DTensor's dispatch; the prefill cell of the
    same tokens on flash, every launch on the local heads, its logits
    against the unsharded prefill's; MESH_DECODE decode steps on the
    cache the prefill placed. (b) two spawned processes on the card over
    the host-staged gloo backend at DP_GLOO_LAYERS layers: each of
    MESH_GLOO_RUNS within the same rule of the one-process step at that
    depth (the bf16 tensor-parallel run reported), this rank's bytes, the collectives' share of a step, and the
    tensor-parallel prefill on 8 of the 16 heads a rank. A part that
    raises is reported and the next one runs; the phase fails after."""
    import json
    import tempfile
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config

    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    config = get_config(TRAIN_ARCH)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 29).integers(
        0, config.vocab_size, (TRAIN_B, TRAIN_S)))
    batch = {"tokens": tokens.to(dev)}
    OUT.mkdir(parents=True, exist_ok=True)
    failed, counts = [], {"mesh": {}, "mesh_gloo_tp": {}}

    def part(label, fn, default):
        try:
            return fn()
        except Exception:
            print(f"      {label} raised:\n{traceback.format_exc()}",
                  flush=True)
            failed.append(f"{label} raised")
            return default

    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
            rank=0, world_size=1, device_id=dev)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            print(f"  (a) {TRAIN_ARCH} at full width, {TRAIN_B} x {TRAIN_S} "
                  f"tokens, NCCL world 1 on a (data 1, model 1) mesh, "
                  f"deterministic algorithms:", flush=True)
            failed += part("(a) the train cell", lambda: _mesh_world1_train(
                torch, dev, config, batch, mesh), [])
            torch.cuda.empty_cache()
            bad, counts["mesh"] = part("(a) the prefill cell", lambda:
                                       _mesh_world1_serve(torch, dev, config,
                                                          batch, mesh),
                                       ([], {}))
            failed += bad
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        short = tokens[:, :MESH_GLOO_S]
        bad, counts["mesh_gloo_tp"] = part("(b) the gloo processes", lambda:
                                           _mesh_gloo(torch, dev, config,
                                                      short,
                                                      {"tokens": short.to(
                                                          dev)}, tmp),
                                           ([], {}))
        failed += bad
    (OUT / MESH_LAUNCHES).write_text(json.dumps({
        name: [[k[0], k[1], n] for k, n in c.items()]
        for name, c in counts.items()}))
    if failed:
        raise AssertionError(f"outside the bounds: {failed}")
    return 0


def mesh_phase(torch, dev, smi: str) -> dict:
    """Phase 29: ``mesh_child`` in a child process, as phase 28 runs its
    own. Returns the flash launches of (a)'s prefill cell ('mesh') and of
    (b)'s tensor-parallel prefill over its ranks ('mesh_gloo_tp'), by
    (design, head dim)."""
    import json

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    (OUT / MESH_LAUNCHES).unlink(missing_ok=True)
    rc = subprocess.run([sys.executable, "-c",
                         "import sys, chip_smoke; "
                         "sys.exit(chip_smoke.mesh_child())"],
                        cwd=ROOT, env=_child_env(), timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"the mesh failed (exit {rc})")
    counts = json.loads((OUT / MESH_LAUNCHES).read_text())
    print(f"  the mesh OK; {time.perf_counter() - t_phase:.1f} s, on {smi}",
          flush=True)
    return {name: {(d, hd): n for d, hd, n in rows}
            for name, rows in counts.items()}


# phase 30: the all-to-all MoE (models/moe.py's moe_layer_a2a, the block's
# _moe_impl branch) and the GPipe pipeline (parallel/pp.py), in a child
# process under deterministic algorithms as phases 28-29: (a) NCCL at world
# 1 on a (data 1, model 1) mesh, the reference's fallback to the scatter
# dispatch; (b) two host-staged gloo processes on (data 2, model 1), each
# owning 20 of granite's 40 experts a layer, its tokens routed by
# all-to-all; (c) two host-staged gloo processes as the 2 stages of a
# (pod 2, data 1, model 1) mesh, internlm2-1.8b's 24 blocks in fp32
A2A_OVERRIDES = {"_moe_impl": "a2a", "_moe_pad_experts": 2}
A2A_WORLD, A2A_DECODE = 2, 2   # (b)'s decode steps: 8 until phase 31
# the fp32 prefill's and the train step's tokens a row: the reference's
# local buffer, (experts a rank, ranks x capacity, d_model), is 10 GB a
# layer in fp32 at capacity factor 5.0 and 1,024 tokens a row, with as
# much again for its products, in each of the two processes on one card
# (the fp32 prefill's 512 cut to 128 to make room for phase 31)
A2A_FP32_S, A2A_TRAIN_S, A2A_TRAIN_LAYERS = 128, 256, 2
A2A_TOL = dict(rtol=2e-3, atol=2e-3)    # tests/test_multidevice.py:240
A2A_AUX_RTOL = 1e-5
# (c)'s tokens a row: 1,024 until phase 31 took the time
PP_B, PP_S, PP_MICRO = 4, 256, 4
PP_FWD_TOL, PP_GRAD_TOL = 2e-5, 2e-4    # tests/test_multidevice.py:268-276
A2A_LAUNCHES = "a2a_launches.json"


def _own(tree):
    """A placed tree whose sharded leaves are copies of this rank's
    blocks, so that the full tensors they were cut from can be freed."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import is_dtensor

    def own(t):
        if not is_dtensor(t) or t.to_local().numel() == t.numel():
            return t
        return DTensor.from_local(t.to_local().clone(), t.device_mesh,
                                  t.placements, run_check=False)
    if isinstance(tree, dict):
        return {k: _own(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_own(v) for v in tree]
    return own(tree)


def _within(torch, got, want, rtol: float, atol: float) -> bool:
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _a2a_world1(torch, dev) -> tuple[list[str], dict]:
    """Phase 30 (a): the failures and the a2a run's flash launches."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer
    from repro_torch.models.moe import padded_experts
    from repro_torch.parallel.sharding import use_mesh, whole
    from repro_torch.training import shardings_for

    config = get_config(MOE_ARCH)
    a2a = config.replace(sharding_overrides=A2A_OVERRIDES)
    params = _draw(torch, dev, config)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 30).integers(
        0, config.vocab_size, (MODEL_B, MODEL_S))).to(dev)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    cell = shardings_for(a2a, ShapeConfig("a2a", MODEL_S, MODEL_B, "prefill"),
                         mesh)
    with torch.inference_mode():
        plain, _ = transformer.prefill(params, {"tokens": tokens}, config)
        placed = cell.place(params, cell.param_specs)
        batch = cell.place({"tokens": tokens}, cell.batch_specs)
        with use_mesh(cell.mesh, cell.rules):
            transformer.prefill(placed, batch, a2a)
            torch.cuda.synchronize(dev)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            logits, _ = transformer.prefill(placed, batch, a2a)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
        launched = _launched(fk.flash_attention.launches_by_instance)
        equal = torch.equal(whole(logits), plain)
    print(f"  (a) {MOE_ARCH} at full width in bf16, the a2a overrides "
          f"{A2A_OVERRIDES} (E_pad {padded_experts(a2a)} of "
          f"{config.num_experts}), NCCL world 1 on a (data 1, model 1) mesh, "
          f"no expert axis larger than 1, so the reference's fallback: "
          f"prefill of {MODEL_B} x {MODEL_S} tokens {ms:.1f} ms with flash "
          f"{launched}, last-token logits bit-equal to the unpadded scatter "
          f"run's without a mesh: {equal}", flush=True)
    want = {("wgmma", config.resolved_head_dim): config.num_layers}
    if not equal or launched != want:
        return [f"(a) bit-equal {equal}, launches {launched} (want "
                f"{want})"], launched
    return [], launched


def _a2a_recording(moe, whole):
    """Records each call of ``moe.moe_layer_a2a`` inside the block:
    (the input, the output, the aux loss), each whole (a collective on
    every rank)."""
    seen, fn = [], moe.moe_layer_a2a

    def recording(h, params, config):
        out, aux = fn(h, params, config)
        seen.append((whole(h), whole(out), whole(aux)))
        return out, aux
    return seen, fn, recording


def _a2a_bf16(torch, dev, mesh, rank: int) -> dict:
    """Phase 30 (b)'s bf16 prefill of MODEL_B x MODEL_S tokens (phase (a)'s)
    with the a2a branch, timed as the first (DTensor's sharding caches
    cold), then A2A_DECODE greedy decode steps; rank 0 also runs the
    one-process scatter prefill on the full tree first."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model
    from repro_torch.parallel import sharding
    from repro_torch.training import shardings_for

    config = get_config(MOE_ARCH)
    a2a = config.replace(sharding_overrides=A2A_OVERRIDES)
    params = get_model(config).init(torch.Generator(device=dev).manual_seed(
        SEED), config)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 30).integers(
        0, config.vocab_size, (MODEL_B, MODEL_S))).to(dev)
    out = {}
    with torch.inference_mode():
        plain = (transformer.prefill(params, {"tokens": tokens}, config)[0]
                 if rank == 0 else None)
        cell = shardings_for(a2a, ShapeConfig("a2a", MODEL_S, MODEL_B,
                                              "prefill"), mesh)
        placed = _own(cell.place(params, cell.param_specs))
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        out["bytes"] = _local_bytes(placed)
        batch = cell.place({"tokens": tokens}, cell.batch_specs)
        staged = sharding.host_staged_class()
        max_len = MODEL_S + A2A_DECODE
        with sharding.use_mesh(cell.mesh, cell.rules):
            torch.cuda.synchronize(dev)
            kernels.reset_launch_counts()
            c0, t0 = staged.seconds, time.perf_counter()
            logits, cache = transformer.prefill(placed, batch, a2a, max_len)
            torch.cuda.synchronize(dev)
            out["prefill_s"] = time.perf_counter() - t0
            out["prefill_coll"] = staged.seconds - c0
            out["launched"] = _launched(
                fk.flash_attention.launches_by_instance)
            logits = sharding.whole(logits)
            if plain is not None:
                out["diff"] = _max_err(torch, logits.float(), plain.float())
            toks = []
            for i in range(A2A_DECODE):
                if i == 1:
                    torch.cuda.synchronize(dev)
                    c0, t0 = staged.seconds, time.perf_counter()
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                toks.append(tok)
                logits, cache = transformer.decode_step(placed, tok, cache,
                                                        a2a)
                logits = sharding.whole(logits)
            torch.cuda.synchronize(dev)
            out["decode_s"] = (time.perf_counter() - t0) / (A2A_DECODE - 1)
            out["decode_coll"] = (staged.seconds - c0) / (A2A_DECODE - 1)
            out["tokens"] = torch.cat(toks, 1).cpu().tolist()
            out["finite"] = bool(torch.isfinite(logits).all())
    out["peak"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def _a2a_fp32(torch, dev, mesh, rank: int) -> dict:
    """Phase 30 (b)'s fp32 prefill of MODEL_B x A2A_FP32_S tokens at the
    drop-free capacity factor E/k: each layer's a2a output and aux loss
    held against ``moe_layer`` on that layer's own input and weights, and
    (reported) the logits' difference from the one-process scatter
    prefill and the share of routing decisions that differ from it."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import moe, transformer
    from repro_torch.models.registry import get_model
    from repro_torch.parallel import sharding
    from repro_torch.training import shardings_for

    config = get_config(MOE_ARCH)
    config = config.replace(
        dtype="float32", param_dtype="float32",
        capacity_factor=config.num_experts / config.experts_per_token)
    a2a = config.replace(sharding_overrides=A2A_OVERRIDES)
    K = config.experts_per_token
    params = get_model(config).init(torch.Generator(device=dev).manual_seed(
        SEED), config)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 31).integers(
        0, config.vocab_size, (MODEL_B, A2A_FP32_S))).to(dev)
    T = MODEL_B * A2A_FP32_S
    out = {}
    with torch.inference_mode():
        if rank == 0:
            with _capture(moe, "moe_layer") as ins:
                plain, _ = transformer.prefill(params, {"tokens": tokens},
                                               config)
            routes = [moe.route(h.reshape(T, -1), params["layers"][i]["moe"][
                "router"], K)[2].sort(-1).values for i, h in enumerate(ins)]
            del ins
            # every layer's whole experts, kept on the host for the checks
            kept = [{k: v.to("cpu") for k, v in layer["moe"].items()}
                    for layer in params["layers"]]
        cell = shardings_for(a2a, ShapeConfig("a2a", A2A_FP32_S, MODEL_B,
                                              "prefill"), mesh)
        placed = _own(cell.place(params, cell.param_specs))
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        batch = cell.place({"tokens": tokens}, cell.batch_specs)
        seen, fn, recording = _a2a_recording(moe, sharding.whole)
        moe.moe_layer_a2a = recording
        try:
            with sharding.use_mesh(cell.mesh, cell.rules):
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                logits, _ = transformer.prefill(placed, batch, a2a)
                torch.cuda.synchronize(dev)
                out["prefill_s"] = time.perf_counter() - t0
        finally:
            moe.moe_layer_a2a = fn
        out["launched"] = _launched(fk.flash_attention.launches_by_instance)
        out["peak"] = torch.cuda.max_memory_allocated(dev) / 1e9
        logits = sharding.whole(logits).float()
        worst, aux_worst, flips, held = 0.0, 0.0, [], True
        for i, (h, got, aux) in enumerate(seen if rank == 0 else ()):
            layer = {k: v.to(dev) for k, v in kept[i].items()}
            want, aux0 = moe.moe_layer(h, layer, config)
            worst = max(worst, _max_err(torch, got, want))
            aux_rel = abs(float(aux) - float(aux0)) / abs(float(aux0))
            aux_worst = max(aux_worst, aux_rel)
            held = held and _within(torch, got, want, **A2A_TOL) and \
                aux_rel <= A2A_AUX_RTOL
            mine = moe.route(h.reshape(T, -1), layer["router"], K)[2]
            flips.append(int((mine.sort(-1).values != routes[i]).any(-1)
                             .sum()))
        out["layers"] = len(seen)
        if rank == 0:
            out.update(held=held, worst=worst, aux_worst=aux_worst,
                       flips=flips,
                       diff=_max_err(torch, logits, plain.float()),
                       finite=bool(torch.isfinite(logits).all()))
    return out


def _a2a_train(torch, dev, mesh, rank: int) -> dict:
    """Phase 30 (b)'s train step: granite at A2A_TRAIN_LAYERS layers, fp32,
    capacity factor E/k, the loss's gradients through the all-to-alls on
    ``shardings_for``'s train cell against the one-process scatter step's
    (rank 0), within TRAIN_GRAD_TOL of each leaf's largest magnitude."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, ShapeConfig
    from repro_torch.models.registry import get_model
    from repro_torch.parallel import sharding
    from repro_torch.training import loss_and_grads, shardings_for, \
        train_config
    from repro_torch.utils import tree_leaves

    config = get_config(MOE_ARCH)
    config = train_config(config.replace(
        num_layers=A2A_TRAIN_LAYERS, dtype="float32", param_dtype="float32",
        capacity_factor=config.num_experts / config.experts_per_token))
    a2a = config.replace(sharding_overrides=A2A_OVERRIDES)
    params = get_model(config).init(torch.Generator(device=dev).manual_seed(
        SEED), config)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 32).integers(
        0, config.vocab_size, (MODEL_B, A2A_TRAIN_S))).to(dev)
    out = {}
    if rank == 0:
        loss0, _, want = loss_and_grads(params, {"tokens": tokens}, config)
        want = tree_leaves(want)
    cell = shardings_for(a2a, ShapeConfig("a2a", A2A_TRAIN_S, MODEL_B,
                                          "train"), mesh, OptimizerConfig())
    placed = _own(cell.place(params, cell.state_specs["params"]))
    del params
    torch.cuda.empty_cache()
    batch = cell.place({"tokens": tokens}, cell.batch_specs)
    staged = sharding.host_staged_class()
    with sharding.use_mesh(cell.mesh, cell.rules):
        torch.cuda.synchronize(dev)
        c0, t0 = staged.seconds, time.perf_counter()
        loss, _, grads = loss_and_grads(placed, batch, a2a)
        torch.cuda.synchronize(dev)
        out["step_s"] = time.perf_counter() - t0
        out["coll"] = staged.seconds - c0
        got = tree_leaves(sharding.gather_tree(grads))
        loss = float(sharding.whole(loss))
    if rank == 0:
        errs = [_max_err(torch, g.float(), w.float())
                / max(float(w.abs().max()), 1e-30) for g, w in zip(got, want)]
        out.update(leaves=len(got), worst=max(errs),
                   held=len(got) == len(want) and max(errs) <= TRAIN_GRAD_TOL,
                   loss=loss, loss0=float(loss0))
    return out


def _a2a_gloo_rank(rank: int, world: int, init: str, device: str,
                   results) -> None:
    """One of phase 30 (b)'s processes, on the host-staged gloo backend,
    on a (data 2, model 1) mesh: the bf16 prefill and decode, the fp32
    prefill held layer by layer, the train step's gradients."""
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    try:
        torch.use_deterministic_algorithms(True)
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        from repro_torch.parallel.sharding import register_host_staged
        dist.init_process_group(register_host_staged(), init_method=init,
                                rank=rank, world_size=world)
        try:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cuda", (world, 1),
                                    mesh_dim_names=("data", "model"))
            out = {"errors": {}}
            for label, fn in (("bf16", _a2a_bf16), ("fp32", _a2a_fp32),
                              ("train", _a2a_train)):
                try:
                    out[label] = fn(torch, dev, mesh, rank)
                except Exception:
                    out["errors"][label] = traceback.format_exc()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def _a2a_gloo(torch, dev, tmp: str) -> tuple[list[str], dict, dict]:
    """Phase 30 (b); the failures and the flash launches over the ranks of
    the bf16 and the fp32 prefills."""
    from repro_torch.configs import get_config

    config = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    store = Path(tmp) / "a2a"          # a store of its own: (c) follows
    store.mkdir()
    ranks = _spawn_group(A2A_WORLD, store, dev, target=_a2a_gloo_rank)
    print(f"  (b) {A2A_WORLD} host-staged gloo processes on a (data "
          f"{A2A_WORLD}, model 1) mesh, {MOE_ARCH} at full width and depth "
          f"with {A2A_OVERRIDES}, {config.num_experts // A2A_WORLD} of its "
          f"{config.num_experts} experts a layer on each process "
          f"({time.perf_counter() - t0:.1f} s with their start):",
          flush=True)
    failed, launched, launched32 = [], {}, {}
    hd = config.resolved_head_dim
    for r, out in enumerate(ranks):
        for label, err in out["errors"].items():
            print(f"      rank {r}, {label} failed:\n{err}", flush=True)
            failed.append(f"(b) rank {r}, {label}")
        if "bf16" in out:
            b = out["bf16"]
            for key, n in b["launched"].items():
                launched[key] = launched.get(key, 0) + n
            print(f"      rank {r}, bf16: this rank's parameters "
                  f"{b['bytes'] / 1e9:.3f} GB; prefill of {MODEL_B} x "
                  f"{MODEL_S} tokens ({MODEL_B // A2A_WORLD} rows a rank) "
                  f"{b['prefill_s'] * 1e3:.1f} ms, flash {b['launched']}, "
                  f"host-staged collectives {b['prefill_coll'] * 1e3:.1f} ms "
                  f"(share {b['prefill_coll'] / b['prefill_s']:.3f})"
                  + (f", last-token logits max|diff| {b['diff']:.4g} from "
                     f"the one-process scatter prefill (reported: bf16, and "
                     f"capacity drops are per rank here)" if "diff" in b
                     else "")
                  + f"; {A2A_DECODE} decode steps, "
                  f"{b['decode_s'] * 1e3:.1f} ms a step after the first "
                  f"(collectives {b['decode_coll'] * 1e3:.1f} ms), tokens "
                  f"{b['tokens']}; peak {b['peak']:.2f} GB", flush=True)
            if b["launched"] != {("wgmma", hd): config.num_layers} or \
                    not b["finite"]:
                failed.append(f"(b) rank {r}, the bf16 prefill")
        if "fp32" in out:
            f = out["fp32"]
            for key, n in f["launched"].items():
                launched32[key] = launched32.get(key, 0) + n
            line = (f"      rank {r}, fp32 at capacity factor "
                    f"{config.num_experts / config.experts_per_token}: "
                    f"prefill of {MODEL_B} x {A2A_FP32_S} tokens "
                    f"{f['prefill_s'] * 1e3:.1f} ms (with each layer's "
                    f"input and output gathered), flash {f['launched']}, "
                    f"peak {f['peak']:.2f} GB")
            if "held" in f:
                T = MODEL_B * A2A_FP32_S
                line += (f"; each of {f['layers']} layers' a2a output "
                         f"against moe_layer on its own input: largest "
                         f"max|diff| {f['worst']:.3g} (rtol/atol "
                         f"{A2A_TOL['atol']}), aux {f['aux_worst']:.3g} "
                         f"relative (limit {A2A_AUX_RTOL}): held "
                         f"{f['held']}; reported: last-token logits max|diff|"
                         f" {f['diff']:.4g} from the one-process scatter "
                         f"prefill, routing decisions that differ from its "
                         f"{sum(f['flips'])} of {f['layers'] * T} (by layer "
                         f"{f['flips']})")
                if not (f["held"] and f["finite"] and
                        f["layers"] == config.num_layers):
                    failed.append(f"(b) rank {r}, the fp32 prefill")
            print(line, flush=True)
            if f["launched"] != {("tf32x3", hd): config.num_layers}:
                failed.append(f"(b) rank {r}, the fp32 prefill's launches")
        if "train" in out:
            t = out["train"]
            line = (f"      rank {r}, train step at {A2A_TRAIN_LAYERS} "
                    f"layers, {MODEL_B} x {A2A_TRAIN_S} tokens, fp32: loss "
                    f"and gradients {t['step_s'] * 1e3:.1f} ms, host-staged "
                    f"collectives {t['coll'] * 1e3:.1f} ms")
            if "held" in t:
                line += (f"; against the one-process scatter step: loss "
                         f"{t['loss']:.6f} / {t['loss0']:.6f}, the largest "
                         f"gradient difference {t['worst']:.3g} of its "
                         f"leaf's largest magnitude over {t['leaves']} "
                         f"leaves (limit {TRAIN_GRAD_TOL}): held {t['held']}")
                if not t["held"]:
                    failed.append(f"(b) rank {r}, the train step")
            print(line, flush=True)
    return failed, launched, launched32


def _pp_rank(rank: int, world: int, init: str, device: str,
             results) -> None:
    """One of phase 30 (c)'s two stages, on the host-staged gloo backend:
    ``pipeline_layers`` over TRAIN_ARCH's blocks in fp32 (the train
    config's schedule, its remat), forward and the gradient of sum(y²)
    with respect to this stage's blocks, then the same blocks in sequence
    in this process, held to each other."""
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    try:
        torch.use_deterministic_algorithms(True)
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        from repro_torch.parallel.sharding import register_host_staged
        dist.init_process_group(register_host_staged(), init_method=init,
                                rank=rank, world_size=world)
        try:
            out = _pp_run(torch, dev, rank, world)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def _pp_run(torch, dev, rank: int, world: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.pp import pipeline_layers
    from repro_torch.training import rules_for, train_config
    from repro_torch.utils import tree_leaves

    config = train_config(get_config(TRAIN_ARCH).replace(
        dtype="float32", param_dtype="float32"))
    mesh = init_device_mesh("cuda", (world, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    layers = get_model(config).init(torch.Generator(device=dev).manual_seed(
        SEED), config)["layers"]
    x = torch.randn((PP_B, PP_S, config.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED + 30))
    per = config.num_layers // world
    mine = tree_leaves(layers[rank * per:(rank + 1) * per])
    for p in tree_leaves(layers):
        p.requires_grad_()

    def block(rows: int):
        positions = torch.arange(PP_S, device=dev).expand(rows, PP_S)
        return L.remat(lambda h, p: transformer._block(
            h, p, config, positions, None)[0], config.remat)

    staged = sharding.host_staged_class()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    c0, t0 = staged.seconds, time.perf_counter()
    with sharding.use_mesh(mesh, rules_for(config)):
        y = pipeline_layers(block(PP_B // PP_MICRO), layers, x, mesh,
                            config.num_layers, PP_MICRO)
        grads = torch.autograd.grad((y ** 2).sum(), mine)
    torch.cuda.synchronize(dev)
    out = {"pipe_s": time.perf_counter() - t0, "coll": staged.seconds - c0,
           "peak": torch.cuda.max_memory_allocated(dev) / 1e9,
           "stage_params": sum(p.numel() for p in mine)}
    t0 = time.perf_counter()
    run = block(PP_B)
    want = x
    for p in layers:
        want = run(want, p)
    g_want = torch.autograd.grad((want ** 2).sum(), mine)
    torch.cuda.synchronize(dev)
    out["seq_s"] = time.perf_counter() - t0
    scale = float(want.detach().abs().max())
    out["fwd"] = _max_err(torch, y.detach(), want.detach()) / scale
    out["grad"] = max(_max_err(torch, g, w) / max(float(w.abs().max()), 1e-30)
                      for g, w in zip(grads, g_want))
    out["finite"] = bool(torch.isfinite(y).all())
    out["leaves"] = len(mine)
    return out


def _pp_gloo(torch, dev, tmp: str) -> list[str]:
    """Phase 30 (c); the failures."""
    from repro_torch.configs import get_config

    config = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    store = Path(tmp) / "pp"
    store.mkdir()
    ranks = _spawn_group(A2A_WORLD, store, dev, target=_pp_rank)
    print(f"  (c) {TRAIN_ARCH}'s {config.num_layers} blocks at full width in "
          f"fp32 as {A2A_WORLD} pipeline stages of host-staged gloo "
          f"processes on (pod {A2A_WORLD}, data 1, model 1), x ({PP_B}, "
          f"{PP_S}, {config.d_model}) in {PP_MICRO} microbatches "
          f"({time.perf_counter() - t0:.1f} s with their start):", flush=True)
    failed = []
    for r, out in enumerate(ranks):
        print(f"      stage {r}: {out['leaves']} leaves "
              f"({out['stage_params'] / 1e9:.3f} B parameters); forward and "
              f"the gradient of sum(y^2) {out['pipe_s']:.2f} s, the hops and "
              f"the broadcast (host-staged) {out['coll']:.2f} s (share "
              f"{out['coll'] / out['pipe_s']:.3f}), peak {out['peak']:.2f} "
              f"GB; the same blocks in sequence in this process "
              f"{out['seq_s']:.2f} s; output max|diff| {out['fwd']:.3g} of "
              f"its largest magnitude (limit {PP_FWD_TOL}), gradients "
              f"{out['grad']:.3g} of each leaf's (limit {PP_GRAD_TOL})",
              flush=True)
        if not (out["fwd"] <= PP_FWD_TOL and out["grad"] <= PP_GRAD_TOL
                and out["finite"]):
            failed.append(f"(c) stage {r}")
    return failed


def a2a_pp_child() -> int:
    """Phase 30, in a child process whose environment sets
    ``CUBLAS_WORKSPACE_CONFIG``, under deterministic algorithms: (a)
    ``_a2a_world1``, (b) ``_a2a_gloo``, (c) ``_pp_gloo``. A part that
    raises is reported and the next one runs; the phase fails after."""
    import json
    import tempfile
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    OUT.mkdir(parents=True, exist_ok=True)
    failed, counts = [], {"moe_a2a": {}, "moe_a2a_gloo": {},
                          "moe_a2a_gloo_fp32": {}}

    def part(label, fn, default):
        try:
            return fn()
        except Exception:
            print(f"      {label} raised:\n{traceback.format_exc()}",
                  flush=True)
            failed.append(f"{label} raised")
            return default

    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
            rank=0, world_size=1, device_id=dev)
        try:
            bad, counts["moe_a2a"] = part(
                "(a) the fallback", lambda: _a2a_world1(torch, dev), ([], {}))
            failed += bad
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        bad, counts["moe_a2a_gloo"], counts["moe_a2a_gloo_fp32"] = part(
            "(b) the all-to-all", lambda: _a2a_gloo(torch, dev, tmp),
            ([], {}, {}))
        failed += bad
        failed += part("(c) the pipeline", lambda: _pp_gloo(torch, dev, tmp),
                       [])
    (OUT / A2A_LAUNCHES).write_text(json.dumps({
        name: [[k[0], k[1], n] for k, n in c.items()]
        for name, c in counts.items()}))
    if failed:
        raise AssertionError(f"outside the bounds: {failed}")
    return 0


def a2a_pp_phase(torch, dev, smi: str) -> dict:
    """Phase 30: ``a2a_pp_child`` in a child process, as phases 28-29 run
    theirs. Returns the flash launches of (a)'s prefill ('moe_a2a'), of
    (b)'s bf16 prefills over its ranks ('moe_a2a_gloo') and of its fp32
    prefills ('moe_a2a_gloo_fp32'), by (design, head dim)."""
    import json

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    (OUT / A2A_LAUNCHES).unlink(missing_ok=True)
    rc = subprocess.run([sys.executable, "-c",
                         "import sys, chip_smoke; "
                         "sys.exit(chip_smoke.a2a_pp_child())"],
                        cwd=ROOT, env=_child_env(), timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"the all-to-all MoE and the pipeline failed "
                             f"(exit {rc})")
    counts = json.loads((OUT / A2A_LAUNCHES).read_text())
    print(f"  the all-to-all MoE and the pipeline OK; "
          f"{time.perf_counter() - t_phase:.1f} s, on {smi}", flush=True)
    return {name: {(d, hd): n for d, hd, n in rows}
            for name, rows in counts.items()}


# phase 31: the dry-run (launch/dryrun.py, its walker launch/opcost.py,
# training.lower_cell): (a) internlm2-1.8b's cells traced on fake CUDA
# tensors on the production meshes, work for the host alone, in a process
# that main() starts after phase 1 and phase 31 waits for (its ~90 s of
# tracing would otherwise lengthen the script by as much); (b) in a child
# process, the cells of phase 29 (a)'s sizes on a (data 1, model 1) mesh
# traced on fake tensors, then run for real under the same walker and
# timed, at NCCL world 1
DRYRUN_CELLS = (("train_4k", False), ("prefill_32k", False),
                ("decode_32k", False), ("train_4k", True))
# (a)'s records and output: beside OUT, which phase 5 empties
DRYRUN_OUT = ROOT / "build" / "chip_smoke_dryrun"
# (b): phase 29 (a)'s train and prefill cells, 4 x 1,024 tokens; a decode
# step over decode_32k's 32,768 cached positions with its batch of 128
# rows cut to 4, whose cache (12.9 GB in bf16) the card holds
DRYRUN_HELD = (("train", TRAIN_S, TRAIN_B), ("prefill", TRAIN_S, TRAIN_B),
               ("decode", 32_768, TRAIN_B))
DRYRUN_TIMED = 2                    # timed steps a cell, after the walked one
DRYRUN_PEAK_RTOL = 0.10             # traced peak against the allocator's
DRYRUN_BOUND_SLACK = 1.05           # no step under its largest term / 1.05
DRYRUN_LAUNCHES = "dryrun_launches.json"


def _dryrun_production(torch) -> list[str]:
    """Phase 31 (a): DRYRUN_CELLS on the (16, 16) and (2, 16, 16)
    production meshes; the failures."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell

    failed, layers = [], get_config(ARCH).num_layers
    for shape, multi in DRYRUN_CELLS:
        rec = run_cell(ARCH, shape, multi,
                       str(DRYRUN_OUT / ("multi" if multi else "single")),
                       device="cuda")
        if not rec["ok"]:
            failed.append(f"(a) {shape} on {rec['mesh']}")
            continue
        cost, rf, mem = rec["cost"], rec["roofline"], rec["memory"]
        calls = cost["kernel_calls"].get("flash_attention", 0)
        print(f"  (a) {ARCH} x {shape} on ({rec['mesh']}), {rec['chips']} "
              f"cards: traced in {rec['trace_s']} s; a card's flops "
              f"{cost['flops']:.4e}, bytes {cost['bytes']:.4e}, NVLink "
              f"{cost['nvlink_bytes']:.4e}, network "
              f"{cost['network_bytes']:.4e} ({cost['collectives']}); peak "
              f"{mem['peak_bytes'] / 1e9:.3f} GB at {mem['peak_scope']} "
              f"(arguments {mem['argument_bytes'] / 1e9:.3f}); roofline "
              f"compute {rf['compute_s'] * 1e3:.3f} ms, memory "
              f"{rf['memory_s'] * 1e3:.3f} ms, NVLink "
              f"{rf['nvlink_s'] * 1e3:.3f} ms, network "
              f"{rf['network_s'] * 1e3:.3f} ms: {rf['dominant']}; useful "
              f"{rf['useful_ratio']:.3f}; {cost['ops']} operations counted, "
              f"flash operator calls {calls}", flush=True)
        if shape.startswith("prefill") and calls != layers:
            failed.append(f"(a) {shape}: {calls} flash calls, want "
                          f"{layers}")
    return failed


def dryrun_cells_child() -> int:
    """Phase 31 (a), in a process of its own on the host."""
    import logging

    import torch

    sys.path.insert(0, str(SRC))
    # DTensor warns at every redistribution over two mesh dimensions
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    os.nice(10)             # the phases it runs beside take the host first
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    failed = _dryrun_production(torch)
    print(f"  (a) in {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"  (a) outside the bounds: {failed}", flush=True)
    return 1 if failed else 0


def start_dryrun_cells():
    """Start phase 31 (a) (``dryrun_cells_child``), its output into
    DRYRUN_OUT/cells.log; the caller stops it."""
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    with open(DRYRUN_OUT / "cells.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.dryrun_cells_child())"],
            cwd=ROOT, env=_child_env(), stdout=log, stderr=subprocess.STDOUT)


def stop(proc) -> None:
    """Kill ``proc`` if it still runs, and reap it."""
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)


def _dryrun_shape(kind: str, S: int, B: int):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(f"held_{kind}", S, B, kind)


def _dryrun_held(torch, dev, tmp: str) -> tuple[list[str], dict]:
    """Phase 31 (b): each DRYRUN_HELD cell traced on fake CUDA tensors
    under a fake group of one, then, under NCCL at world 1, run once for
    real under the walker (the allocator's peak reset with the inputs
    placed) and DRYRUN_TIMED times more, timed. Returns the failures and
    the flash launches of the real prefill."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.dryrun import fake_group, roofline, trace_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.opcost import OpCost
    from repro_torch.training import lower_cell

    config = get_config(ARCH)
    opt = OptimizerConfig(**DP_OPT)
    traced = {}
    with fake_group(1):
        mesh = make_test_mesh(1, 1, device_type="cuda")
        for kind, S, B in DRYRUN_HELD:
            cell, _ = lower_cell(config, _dryrun_shape(kind, S, B), mesh,
                                 opt)
            traced[kind] = trace_cell(cell)
    failed, launched = [], {}
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
        rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_test_mesh(1, 1)
        for kind, S, B in DRYRUN_HELD:
            shape = _dryrun_shape(kind, S, B)
            cell, _ = lower_cell(config, shape, mesh, opt, device=dev)
            args = cell.inputs()
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            kernels.reset_launch_counts()
            walker = OpCost(memory=True)
            walker.track(args)
            t0 = time.perf_counter()
            with walker:
                out = cell(*args)
            torch.cuda.synchronize(dev)
            walked_s = time.perf_counter() - t0
            real_peak = torch.cuda.max_memory_allocated(dev)
            if kind == "prefill":
                launched = _launched(fk.flash_attention.launches_by_instance)
            del out
            times = []
            for _ in range(DRYRUN_TIMED):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                out = cell(*args)
                torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t0)
                del out
            del args
            torch.cuda.empty_cache()
            fake, real = traced[kind]["cost"], walker.result()
            rf = roofline(fake, config, shape, 1)
            terms = {t: rf[f"{t}_s"] for t in ("compute", "memory",
                                               "nvlink", "network")}
            top, top_s = max(terms.items(), key=lambda kv: kv[1])
            fpeak = traced[kind]["memory"]["peak_bytes"]
            same = all(fake[k] == real[k] for k in ("flops", "bytes"))
            peak_off = abs(fpeak - real_peak) / real_peak
            floor = top_s / DRYRUN_BOUND_SLACK
            median = statistics.median(times)
            print(f"  (b) {kind}, {B} x {S}: traced in "
                  f"{traced[kind]['trace_s']:.1f} s; flops fake "
                  f"{fake['flops']:.6e} / real {real['flops']:.6e}, bytes "
                  f"fake {fake['bytes']:.6e} / real {real['bytes']:.6e}: "
                  f"equal {same}; peak traced {fpeak / 1e9:.3f} GB, "
                  f"allocator {real_peak / 1e9:.3f} GB ({peak_off:.4f} off, "
                  f"limit {DRYRUN_PEAK_RTOL}); the walked step "
                  f"{walked_s:.3f} s, timed steps (s) "
                  f"{[round(t, 4) for t in times]}; roofline "
                  f"{ {t: round(v * 1e3, 3) for t, v in terms.items()} } ms, "
                  f"largest {top} {top_s * 1e3:.3f} ms: roofline share "
                  f"{top_s / median:.4f} of the median step"
                  + (f"; flash launches {launched}" if kind == "prefill"
                     else ""), flush=True)
            if not same:
                failed.append(f"(b) {kind}: fake and real counts differ")
            if peak_off > DRYRUN_PEAK_RTOL:
                failed.append(f"(b) {kind}: peak {peak_off:.4f} off")
            if min(times) < floor:
                failed.append(f"(b) {kind}: a step under its bound")
            if kind == "prefill":
                calls = traced[kind]["cost"]["kernel_calls"].get(
                    "flash_attention", 0)
                want = {("wgmma", config.resolved_head_dim): calls}
                if calls != config.num_layers or launched != want:
                    failed.append(f"(b) prefill: {calls} traced flash "
                                  f"calls, launches {launched}")
    finally:
        dist.destroy_process_group()
    return failed, launched


def dryrun_child() -> int:
    """Phase 31 (b) in a child process: a fake process group and a real
    one are each the default group in turn, which no other phase may
    hold."""
    import json
    import logging
    import tempfile

    import torch

    sys.path.insert(0, str(SRC))
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        failed, launched = _dryrun_held(torch, dev, tmp)
    print(f"  (b) in {time.perf_counter() - t0:.1f} s", flush=True)
    (OUT / DRYRUN_LAUNCHES).write_text(json.dumps({
        "dryrun": [[k[0], k[1], n] for k, n in launched.items()]}))
    if failed:
        raise AssertionError(f"outside the bounds: {failed}")
    return 0


def dryrun_phase(torch, dev, smi: str, cells=None) -> dict:
    """Phase 31: (b) ``dryrun_child`` in a child process, after this
    process released what it held on the card; then (a), the process
    ``cells`` that ``start_dryrun_cells`` started (started here when
    None), waited for and its output printed. Returns the flash launches
    of (b)'s real prefill ('dryrun'), by (design, head dim)."""
    import json

    t_phase = time.perf_counter()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    (OUT / DRYRUN_LAUNCHES).unlink(missing_ok=True)
    try:
        if cells is None:
            cells = start_dryrun_cells()
        rc = subprocess.run([sys.executable, "-c",
                             "import sys, chip_smoke; "
                             "sys.exit(chip_smoke.dryrun_child())"],
                            cwd=ROOT, env=_child_env(),
                            timeout=600).returncode
        t_wait = time.perf_counter()
        cells_rc = cells.wait(timeout=600)
        print(f"  (a), started after phase 1, ended "
              f"{time.perf_counter() - t_wait:.1f} s after (b):", flush=True)
        print((DRYRUN_OUT / "cells.log").read_text(), end="", flush=True)
    finally:
        stop(cells)
    if rc != 0 or cells_rc != 0:
        raise AssertionError(f"the dry-run failed (exit {rc}, the traces' "
                             f"{cells_rc})")
    counts = json.loads((OUT / DRYRUN_LAUNCHES).read_text())
    print(f"  the dry-run OK; {time.perf_counter() - t_phase:.1f} s, on "
          f"{smi}", flush=True)
    return {name: {(d, hd): n for d, hd, n in rows}
            for name, rows in counts.items()}


@contextlib.contextmanager
def _phase(label: str, title: str):
    """Prints a phase's header, and its own wall time when it ends."""
    print(f"[{label}] {title}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{label}] done in {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "_build.py").is_file():
        print("chip_smoke: no src/repro_torch next to this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; one NVIDIA "
              "GPU is needed", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    print(f"[1] card: {smi}; torch {torch.__version__} "
          f"(CUDA {torch.version.cuda})", flush=True)
    # phase 31 (a): host work alone, traced while the phases below run
    cells = start_dryrun_cells()
    try:
        return _phases(torch, dev, smi, t_script, cells)
    finally:
        stop(cells)


def _phases(torch, dev, smi: str, t_script: float, cells) -> int:
    """Phases 2-31 of ``main``."""
    from repro_torch.apps.ptycho.sim import simulate
    from repro_torch.kernels import _build

    with _phase("2", "the kernels' build, and SDPA's kernels:"):
        t0 = time.perf_counter()
        lib = _build.build()
        _build.load_library()
        print(f"  {lib.relative_to(ROOT)} loaded in "
              f"{time.perf_counter() - t0:.2f} s, nvcc's build included when "
              f"the log line above says it built", flush=True)
        library_kernels = sdpa_kernels(torch, dev)

    # a 256 MB buffer zeroed between timed calls empties the 50 MB L2, and
    # keeps the device busy while the host enqueues the next call
    with _phase("3", f"kernels against their plain versions at {F}x{H}x{W} "
                     f"(tol 1e-6, overlap against the complex form 1e-5):"):
        l2_flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
        rows = kernel_phase(torch, dev, l2_flush.zero_)
        del l2_flush

    with _phase("4", "raar_step at paper size, kernels against the plain "
                     "path:"):
        problem = simulate(256, 64, 8, device=dev)
        step_phase(torch, dev, problem)

    with _phase("5", "the stream at paper size:"):
        counts = stream_phase(torch, dev)
        for row in rows:
            row["launches"] = counts[row["name"]]

    with _phase("6", "where a RAAR step's device time goes:"):
        profile_phase(torch, dev, problem)
        del problem

    with _phase("7", "the ART kernel against its plain version (float32, "
                     "tol 1e-4; float64 reported):"):
        l2_flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
        art_row = art_phase(torch, dev, l2_flush.zero_)
        del l2_flush
        rows.append(art_row)

    with _phase("8", "the tomography stream at full width:"):
        art_row["launches"], tomo = tomo_phase(torch, dev, art_row["ms"])
        tomo_profile_phase(torch, dev)

    # before the cache is cleared: phases 14 and 21 use phase 8's system
    with _phase("14", "a §IV consumer-group handoff at full width:"):
        art_row["launches_group_handoff"] = group_phase(torch, dev,
                                                        tomo["volume"], smi)
    with _phase("21", "the §IV stream on the TaskScheduler at full width, "
                      "clean and with injected faults:"):
        sched = scheduler_phase(torch, dev, tomo, smi)
        art_row["launches_scheduler"] = sched["a"]
        art_row["launches_scheduler_faults"] = sched["b"]
        del tomo
        from repro_torch.apps.tomo.solver import clear_system_cache
        clear_system_cache()            # the 4.75 GiB system off the card
        torch.cuda.empty_cache()

    with _phase("9", "the flash-attention kernels against their plain "
                     "version (fp32 tol 1e-5, bf16 2e-2):"):
        l2_flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
        flash_rows = flash_phase(torch, dev, l2_flush.zero_)
        del l2_flush
    rows += flash_rows.values()
    # the rows of one design up to hd 128 but hd 64, and of each instance
    # at hd 256 and at hd 64
    hd256_rows = [k for k in FLASH_ROWS if 256 in k[1]]
    hd64_rows = [k for k in FLASH_ROWS if 64 in k[1]]
    base_rows = [k for k in FLASH_ROWS
                 if k not in hd256_rows and k not in hd64_rows]
    flash_rows["wgmma", (128,)]["library_kernels"] = library_kernels[
        "bfloat16"]
    flash_rows["tf32x3", (8, 16, 32, 128)]["library_kernels"] = (
        library_kernels["float32"])

    with _phase("10", f"{ARCH} at full width:"):
        # the fp32 invariant's direct prefill/decode_step loop, not the
        # served path: under a name of its own
        invariant = model_phase(torch, dev)
        for key in base_rows:
            flash_rows[key]["launches_fp32_invariant"] = _row_launches(
                invariant, key)

    with _phase("11", "the serve stream at full width:"):
        served = serve_phase(torch, dev)
        for key in base_rows:
            flash_rows[key]["launches"] = _row_launches(served, key)
        serve_profile_phase(torch, dev)

    with _phase("12", "the §III restart at Table II size:"):
        restart_phase(torch, dev, smi)

    with _phase("13", "the remote ingest at the §III frame shape:"):
        remote_phase(torch, dev, smi)

    with _phase("15", "broker HA under the card's consumer at the §III "
                      "frame shape:"):
        ha_phase(torch, dev, smi)

    by_row = {row["name"]: row for row in rows}
    with _phase("16", "the Spark-MPI bridge: NCCL at world 1, then two "
                      "processes on gloo:"):
        for name, n in bridge_phase(torch, dev, smi).items():
            by_row[name]["launches_group_ranks"] = n
    with _phase("17", "the §III stream with --elastic at Table II size:"):
        for name, n in elastic_phase(torch, dev, smi).items():
            if name in OWN_ROWS:
                by_row[name]["launches_elastic_stream"] = n
    with _phase("18", "elastic checkpoint/restart of the §III solver on "
                      "the card:"):
        for name, n in recovery_phase(torch, dev, smi).items():
            if name in OWN_ROWS:
                by_row[name]["launches_recovery"] = n

    with _phase("19", "the dense configs at full width: gemma-7b (hd 256), "
                      "minitron-8b and starcoder2-3b:"):
        dense = dense_phase(torch, dev, smi)
        for key in hd256_rows:
            flash_rows[key]["launches"] = _row_launches(dense["served"], key)
            flash_rows[key]["launches_fp32_invariant"] = _row_launches(
                dense["invariant"], key)
        for key in base_rows:
            flash_rows[key]["launches_dense_configs"] = _row_launches(
                dense["served"], key)

    with _phase("20", f"the MoE family: {MOE_ARCH} at full width (hd 64):"):
        moe = moe_phase(torch, dev, smi)
        for key in hd64_rows:
            flash_rows[key]["launches"] = _row_launches(moe["served"], key)
            flash_rows[key]["launches_fp32_invariant"] = _row_launches(
                moe["invariant"], key)

    with _phase("22", f"the hybrid family: {HYBRID_ARCH} at full width "
                      f"(window 2,048, {HYBRID_PROMPT}-token prompts):"):
        hybrid_phase(torch, dev, smi)

    with _phase("23", f"the audio family: {AUDIO_ARCH} at full width "
                      f"({AUDIO_PROMPT}-token prompts over 1,500 frames, "
                      f"flash at hd 64):"):
        audio = audio_phase(torch, dev, smi)
        for key in hd64_rows:
            flash_rows[key]["launches_audio"] = _row_launches(
                audio["served"], key)
            flash_rows[key]["launches_audio_fp32_invariant"] = _row_launches(
                audio["invariant"], key)

    with _phase("24", f"the ssm family: {SSM_ARCH} at full width (the "
                      f"chunked WKV, no kernel):"):
        ssm_phase(torch, dev, smi)

    with _phase("25", f"the vlm family: {VLM_ARCH} at full width and full "
                      f"depth (576 image embeddings a request, flash at hd "
                      f"128):"):
        vlm = vlm_phase(torch, dev, smi)
        for key in base_rows:
            flash_rows[key]["launches_vlm"] = _row_launches(vlm["served"],
                                                            key)
            flash_rows[key]["launches_vlm_fp32_invariant"] = _row_launches(
                vlm["invariant"], key)

    with _phase("26", "training: each family's step against the CPU's, "
                      f"{TRAIN_ARCH} at full width, bit-exact resume, the "
                      f"CLI:"):
        trained = train_phase(torch, dev, smi)
        for key in base_rows:
            flash_rows[key]["launches_train"] = _row_launches(trained, key)

    with _phase("27", f"the tiled schedules at full width: {ARCH}'s "
                      f"prefill of one {SCHED_S}-token sequence under each "
                      f"schedule, and its train step on {SCHED_TRAIN_B} x "
                      f"{SCHED_S} tokens:"):
        scheduled = schedules_phase(torch, dev, smi)
        for key in base_rows:
            flash_rows[key]["launches_schedules"] = _row_launches(scheduled,
                                                                  key)

    with _phase("28", "the explicit-collective data-parallel trainer: NCCL "
                      f"at world 1 at full width, then {DP_GLOO_WORLD} gloo "
                      f"processes on the card:"):
        dp_phase(torch, dev, smi)

    with _phase("29", f"the mesh: {TRAIN_ARCH} on a (data 1, model 1) "
                      f"mesh at NCCL world 1 at full width, then "
                      f"{DP_GLOO_WORLD} gloo processes on the card on "
                      f"ZeRO-1 and tensor-parallel meshes:"):
        meshed = mesh_phase(torch, dev, smi)
        for key in FLASH_ROWS:
            for name, counts in meshed.items():
                flash_rows[key]["launches_" + name] = _row_launches(counts,
                                                                    key)

    with _phase("30", f"the all-to-all MoE and the pipeline: {MOE_ARCH} "
                      f"at NCCL world 1, then its experts routed across "
                      f"{A2A_WORLD} gloo processes; {TRAIN_ARCH}'s blocks "
                      f"over {A2A_WORLD} pipeline stages:"):
        routed = a2a_pp_phase(torch, dev, smi)
        for key in FLASH_ROWS:
            for name, counts in routed.items():
                flash_rows[key]["launches_" + name] = _row_launches(counts,
                                                                    key)

    with _phase("31", f"the dry-run: {ARCH}'s cells traced on fake CUDA "
                      f"tensors on the production meshes, and held against "
                      f"its real steps on the card:"):
        dried = dryrun_phase(torch, dev, smi, cells)
        for key in FLASH_ROWS:
            for name, counts in dried.items():
                flash_rows[key]["launches_" + name] = _row_launches(counts,
                                                                    key)

    print(f"all phases in {time.perf_counter() - t_script:.1f} s",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
