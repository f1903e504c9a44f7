#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases 3 to 5 run for each served model in turn (qwen2.5-3b, zamba2-2.7b,
olmoe-1b-7b, falcon-mamba-7b, qwen2-vl-7b, seamless-m4t-medium), each
model freed before the next is built; phase 6 then runs the paper's closed
control loop over full-width qwen2.5-3b replicas, phase 7 its offline
learning and deployment orchestration on the trace phase 6 recorded,
phase 8 the same loop over worker processes (the remote fleet), and phase
9 trains (the train route, full-width qwen2.5-3b steps) and serves the
trained weights.  Any failure exits non-zero and prints no result line.

1. build    — compile the Hopper kernels from ``src/repro_torch/kernels/csrc``.
2. kernels  — hold each kernel against its plain PyTorch version on the
              card, in bf16 at the shapes qwen2.5-3b serving gives it (plus
              one h2o-danube shape), the sampler (K3) at every served
              model's vocabulary, the SSD scan (K7) in float32 at the
              shapes zamba2-2.7b's prefill gives it (timed at 64, 200 and
              2048 tokens), and time kernel, plain version and one library
              call doing the same work; then the attention kernels again
              at zamba2's shared-attention shapes (32 heads, G = 1, hd 80),
              olmoe-1b-7b's (16 heads, G = 1, hd 128), qwen2-vl-7b's (28
              heads over 4 KV heads, G = 7, hd 128, max_seq 2048, K4 at
              1224 tokens) and seamless-m4t-medium's (16 heads, G = 1, hd
              64).  Tolerances:
              decode, paged decode and flash attention atol = rtol = 2e-2
              (bf16 outputs; the plain version rounds its probabilities to
              bf16, the kernels keep them in f32); the paged decode equal
              to the dense one bitwise under an identity table; the
              ring-slot and paged writes and greedy sampling exact; the
              sampler's hash bits bitwise and its noise within 1e-6; the
              SSD scan (y and final state) atol = rtol = 3e-4, the
              reference's own (chunked and sequential sums round
              differently); two identical calls of K1, K5, K3 and K7
              bitwise equal.  The write instances of K1 and K5 (what
              decode runs: the row's K/V write folded into the attention's
              launch), at all three attention shapes, with the written key
              in the first and in the last split, indices below Smax,
              wrapped and mixed, bf16 and float32 new rows: output and
              caches bitwise equal to K2, K2, K1 (K6, K6, K5), caches equal
              to the plain composition and the output within 2e-2 of it;
              timed beside K1 (K5) alone and the unfused three, at all
              five attention shapes.  Then the closed loop's shapes
              (``LoopConfig()``: 4 slots, max_seq 48, a first prefill
              chunk of 8): K4 at (1,8,16,128) over 2 KV heads, the write
              instances of K1 and K5 over a max_seq-48 cache with 4 rows
              (bitwise against K2, K2, K1 and K6, K6, K5), K3 at
              (4, 151936).  Last, K4 and K7 have no backward: with grad
              enabled and an input that requires it each raises
              ``NoBackwardError`` and launches nothing, and under
              ``torch.no_grad`` the same call launches.
3. serve    — each model at full width and depth, random weights from a
              seed, on paths that each have the launch counts set to 0 just
              before and read just after: ``repro_torch.launch.serve.main``
              on the dense pool, prefill unchunked and chunked by 64; and
              ``ServingEngine(pool="paged", spec_k=3)``.  qwen2.5-3b and
              olmoe-1b-7b run it on prompts that share a 136-token prefix,
              with prefix sharing and speculative verify on; zamba2-2.7b
              pages its shared blocks' K/V and falcon-mamba-7b has nothing
              to page, and both serve plain (recurrent state cannot
              rewind).  olmoe's CLI runs at the published capacity factor
              1.25; its paged run on a dropless copy (capacity_factor =
              E/K) and then at 1.25.  qwen2-vl-7b's CLI serves 1224-token
              prompts (1024 patch positions, 200 text tokens) at max_seq
              2048, its --prefill-chunk 64 raised to 1025; its paged run
              puts 1024 shared patch positions before the shared prefix.
              seamless-m4t-medium is driven through ``ServingEngine`` (the
              CLI makes no frames, as in the reference): 8 requests of 200
              decoder tokens over frames of distinct encoder lengths in
              128..1024, dense unchunked and chunked by 64 and paged with
              spec_k=3 (served plain).  Every request must finish, greedy
              ticks must move no logits, the paged runs of the decoder
              models must hit the prefix registry, verify windows and
              accept drafts (qwen2-vl-7b's random-weight streams repeat no
              token, so its drafts are proposed and verified and the
              accepted count printed), the recurrent ones and seamless
              propose none, and every kernel's launch count
              must match the ticks, verify lanes and prefilled admissions
              of the run: decode runs the write instances only, each
              carrying the layer's two row writes, and the standalone K1,
              K2, K5 and K6 launch 0 times; seamless's K4 runs 12 times an
              admission, so none ran in the encoder.
4. streams  — full width: the paged (+ speculative) greedy streams equal
              the dense plain engine's, request for request, for qwen,
              zamba2, falcon, dropless olmoe, qwen2-vl and seamless (at
              1.25 olmoe's are printed, not held, beside the drop fraction
              of one-shot forwards).
              Smoke configs in float32: greedy streams through the kernels
              equal those of the plain versions (the same engine on the
              CPU, same weights), on the dense and the paged engine.
5. profile  — host time of a full-width decode tick (and of a qwen verify
              tick) beside the byte floor of the weights it reads, and the
              device time per kernel over steady-state ticks
              (torch.profiler; device busy is the sum over the device's
              own events, printed beside the sum over host ops and kernels
              alike, which counts a kernel launched by an aten op twice);
              then one profiled admission per model (200 tokens; 1224 for
              qwen2-vl; seamless's with its encoder frames), the named
              kernels' shares (K4, K7) beside the rest.  olmoe's MoE
              layers, falcon's selective scans and seamless's encoder and
              cross attention are timed as ranges of their own; falcon's
              scan loops also by the host clock in an unprofiled
              admission.
6. loop     — ``run_closed_loop`` (``LoopConfig()``, 14 ticks, ``--seed``,
              autoscale, planner mode: router, collector, anomaly
              detector, eviction policy, predictive allocator with its DQN)
              over full-width qwen2.5-3b replicas sharing one EngineCore,
              every tick printed as ``examples/serve_autoscale.py`` prints
              it; the replica trajectory must change.  Again with
              ``pool="paged", spec_k=3``: every request the dense run
              finished is finished by the paged run too (or still in
              flight when it ends), and one both finished has one greedy
              stream.  Each run's launch counts must equal,
              summed over every engine the router built (parked and retired
              ones too), 36 K4 an admission that prefilled, 36 K1 (K5)
              write instances a fused tick (a fused tick or verify lane),
              one K3 a fused tick, and 0 standalone K1, K2, K5, K6.  The
              host clock per router step and per control tick (the loop's
              work outside the router steps), device busy over the router
              steps of one profiled tick, peak memory.  The card's TickLogs
              (every field but ``learn_loss``) must equal the same loop's
              on the CPU at smoke width with qwen's vocabulary: no decision
              reads a token's value.  Last, the allocator's DQN on the card
              against the CPU at one set of bridged weights: q-values on the
              loop's recorded states, 10 ``train_offline`` steps over 256
              transitions from ``--seed``: losses, parameters and
              BatchNorm state within 1e-4 (two pre-BatchNorm biases, whose
              gradient is rounding noise, within AdamW's step bound); the
              times of ``q_values`` and a train step on each.
7. learning — phase 6's dense planner run and its CPU smoke run record
              their traces (``TraceRecorder``): equal, field for field (no
              field reads the host clock).  One set of DNN weights from
              ``--seed`` goes into the allocator of a hybrid loop on each
              device (``LoopConfig()`` with ``alloc_mode="hybrid"``, 14
              ticks: full-width qwen2.5-3b replicas on the card, its launch
              counts checked and added to the kernels line as phase 6's
              are; the smoke config at qwen's vocabulary on the CPU, given
              the full-width deployment vector), whose ``prime_allocator``
              runs ``pretrain_on_trace`` at the reference's defaults (20
              epochs, 60 DQN steps, 30 imitation epochs), each phase
              timed.  A trace carries one deployment vector, so the
              deployment stream's BatchNorms see identical rows and its
              leaves get rounding noise for gradient, which AdamW turns
              into steps of up to 1.2 lr and bn2's ReLU carries into the
              trunk: card and CPU part there.  So the pair is run twice:
              as the path runs (the schedule and draws equal, the first
              loss within 1e-4, the noise-driven elements within AdamW's
              bound, the other gaps printed) and with
              ``exact_deploy_stream`` from ``tests/test_torch_checks.py``
              (identical rows computed exactly), again full width on the
              card against smoke width on the CPU: every loss, parameter
              and BatchNorm statistic within 1e-4.  The exact pair's
              TickLogs must be equal up to the first tick whose decision
              margin (the top two Q-values among the actions the SLO
              envelope admits) is under 10x the card/CPU Q gap on the
              trace's states at the pretrained weights, that tick must
              come after tick 0, and learn_loss must stay within 1e-4 of
              its size (at least 1) while equal.  As the path runs the
              gap is the noise's (Q-values apart by tens), the rule holds
              no tick, and the comparison is only printed.  The
              DQN-decided ticks are counted.  Then, on the card-pretrained
              weights, on both devices: each feature group's raw increase
              of the evaluation loss, permuted as
              ``permutation_importance`` permutes it, on the trace's
              dataset (within 1e-4) and ``DNNSelector`` (``min_trained=
              1``) over each recorded tick's operating point (logits
              within 1e-4 of their size, at least 1; choices equal);
              last, ``RolloutManager`` for the
              chosen strategy, its ``DeployEnv`` carrying qwen2.5-3b's bf16
              bytes and a measured host -> card copy rate, fed the hybrid
              run's latencies against the planner run's: the phases and
              ``elapsed_s`` equal the CPU choice's.
8. fleet    — phase 6's dense loop (``LoopConfig()``, 14 ticks, ``--seed``,
              planner mode, 1 → 3 → 4 → 1 replicas) over worker
              processes, each serving full-width qwen2.5-3b on the card
              through the kernels: at ``topology="proc"`` (each replica a
              ``python -m repro_torch.serving.worker <fd> --device cuda``
              child) and at ``topology="tcp"`` over ``launch_fleet(4,
              device="cuda")`` with a read-only ``MetricsObserver`` on
              worker 0 (``observe_addrs``).  Each run's TickLogs'
              (replicas, reason, served) and every finished stream equal
              phase 6's in-process run of this chip run, bitwise; the
              workers' kernel launch counts (each writes its own, through
              ``REPRO_TORCH_WORKER_LAUNCHES``), summed, equal phase 6's,
              and the router's process launches none; at the first tick of
              4 replicas nvidia-smi lists 4 distinct worker PIDs, none this
              process's, each with its device memory; the observer's
              lifetime counters equal replica 0's through the router;
              ``off_list_spawns`` is 0; no worker outlives its run (all are
              killed in a ``finally``), and the workers load the kernel
              library phase 1 built.  Printed: the host clock per router
              step beside phase 6's, ``transport_ms``, each worker's start
              and ``init`` time; on a failure the workers' exit codes and
              stderr tail.
9. train    — the train route (``LM.forward(..., train=True)``, through
              ``models.steps``): no kernel runs on it, since the kernels have
              no backward and the reference trains with ``use_pallas`` off.
              (1) Every tiny family of ``tests/conftest.py`` (dense, swa,
              vlm, moe dropless, ssm1, ssm2, hybrid, audio; rebuilt here
              without JAX), float32, TF32 off: one seeded CPU model and its
              copy on the card, the counted pipeline's batches: one step's
              loss and every gradient leaf within 1e-4 (of the leaf's
              largest magnitude), 4 AdamW steps' losses within 1e-4
              relative; ``_sdpa_chunked`` and chunked CE at chunk 16 over
              64 tokens against the unchunked forms, values and gradients
              within 1e-5 (CE 1e-6); ``ops.launch_counts()`` unchanged and
              no ``NoBackwardError``.  (2) ``launch.train.main`` at smoke
              width on the card: 6 steps with ``--ckpt-every 3``, then
              ``--resume`` to 9, against an uninterrupted 9-step run: step
              9's metrics and every leaf of step 9's checkpoint within 1e-6
              relative, printed whether bitwise.  (3) Full width: the
              launcher trains qwen2.5-3b (36 layers, 3.09 B float32 masters,
              bf16 compute) 8 steps of 2 x 256 tokens, no checkpoint: every
              logged metric finite, no kernel launched; printed: the peak
              device memory, the host clock per step after the first and
              training tokens per second.  It runs twice: at the launcher's default
              lr 3e-4, whose records are printed (constant and without
              warmup, it overshoots at this depth: the loss swings by
              nats from step to step), and at lr 3e-5, whose last loss
              must be below its first.  One more step of the latter is
              profiled: device busy of the forward and backward alone and
              of the whole step, and the top device ops.  (4) The
              optimizer state freed, the model
              recast and served: 4 requests of 16 tokens through
              ``ServingEngine``, launch counts as phase 3's rules say (36 K4
              an admission, 36 K1 write instances and one K3 a fused tick),
              added to the kernels line; the streams equal those of a fresh
              model loaded with the trained parameters.  The phase prints
              its wall time.

Before the last line it prints one JSON object of per-kernel numbers and the
card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_S = 989e12         # dense bf16 tensor-core rate
PEAK_F32_S = 67e12           # float32 outside the tensor cores
PEAK_TF32_S = 495e12         # dense TF32 tensor-core rate (3 per 3xTF32 product)
ATTN_TOL = 2e-2
SSM_TOL = 3e-4
NOISE_TOL = 1e-6
SPIN_CYCLES = 2_000_000      # ~1 ms at the H100's clock

# serving: qwen2.5-3b at full width, a few requests
SERVE = ["--arch", "qwen2.5-3b", "--device", "cuda", "--requests", "8",
         "--slots", "8", "--max-seq", "1024", "--prompt-len", "200",
         "--gen-len", "16", "--seed", "0"]
N_LAYERS = 36
SLOTS, MAX_SEQ = 8, 1024
# the paged + speculative run: 8 prompts of a shared 136-token prefix (17
# blocks of 8), a unique 24-token tail and, tiled twice, the 16 tokens a
# plain greedy run generated after prefix + tail (so drafts fire)
PREFIX_LEN, TAIL_LEN, GEN_LEN, SPEC_K = 136, 24, 16, 3
# zamba2-2.7b at full width: 54 Mamba2 layers (one K7 launch each per
# prefill) in 9 groups, each followed by a shared attention block (K4 at
# prefill, one K1 or K5 write instance per tick)
ZSERVE = ["--arch", "zamba2-2.7b", "--device", "cuda", "--requests", "8",
          "--slots", "8", "--max-seq", "1024", "--prompt-len", "200",
          "--gen-len", "16", "--seed", "0"]
Z_MAMBA, Z_ATTN = 54, 9
# the kernels of a zamba2 prefill, by a pattern of their CUDA names
ZAMBA2_KERNELS = (("K7", "ssd|ssm"), ("K4", "flash"))
# olmoe-1b-7b at full width: 16 layers of attention (16 heads, 16 KV heads,
# hd 128) and a 64-expert top-8 MoE; falcon-mamba-7b: 64 Mamba1 layers, no
# attention.  The CLI serves both as it serves qwen2.5-3b.
OSERVE = ["--arch", "olmoe-1b-7b"] + SERVE[2:]
FSERVE = ["--arch", "falcon-mamba-7b"] + SERVE[2:]
# qwen2-vl-7b at full width: 28 layers of 28 heads over 4 KV heads (G 7),
# hd 128, vocab 152064.  Every prompt opens with the 1024 patch positions
# (the engine feeds zero patches there), so the CLI's prompts are 1224
# tokens long and max_seq is 2048; --prefill-chunk 64 is raised to 1025
VL_PROMPT, VL_MAX_SEQ = 1224, 2048
VSERVE = ["--arch", "qwen2-vl-7b", "--device", "cuda", "--requests", "8",
          "--slots", "8", "--max-seq", str(VL_MAX_SEQ), "--prompt-len",
          str(VL_PROMPT), "--gen-len", "16", "--seed", "0"]
# seamless-m4t-medium at full width: 12 encoder and 12 decoder layers of 16
# heads of 64 (G 1), vocab 256206.  The CLI makes no frames, so it is
# driven through ServingEngine: 8 requests of a 200-token decoder prompt,
# 16 generated, over frames of distinct encoder lengths in 128..1024 drawn
# from ENC_SEED
ENC_SEED = 0

KERNEL_INFO = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:85"),
    "cache_ring_update": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                          "src/repro/kernels/decode_attention.py:236"),
    "fused_sample": ("src/repro_torch/kernels/csrc/sample.cu",
                     "src/repro/kernels/sample.py:68"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:83"),
    "decode_attention_paged": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:143"),
    "cache_paged_update": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                           "src/repro/kernels/decode_attention.py:196"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:68"),
    # K1 and K5 with K2's and K6's row writes (decode_attention.py:236 and
    # :196) folded into their launch
    "decode_attention_write": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:85"),
    "decode_attention_paged_write": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:143"),
}
# the standalone kernels that decode no longer launches
ROW_WRITES_ALONE = ("decode_attention", "cache_ring_update",
                    "decode_attention_paged", "cache_paged_update")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, reps=25, warmup=3) -> float:
    """Median device time of one call.  Each call follows an L2 flush (the
    serving path finds every layer's operands cold) and a ~1 ms device spin,
    so the host has queued the call before the device reaches it: the events
    time the device work, not the Python wrapper around it."""
    flush = torch.empty(96 << 20, dtype=torch.int8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def ptxas_report(log: str,
                 pattern: str = r"flash|decode|sample|ssd|row_update"):
    """(kernel, registers, spill store bytes, spill load bytes) of every
    kernel in nvcc's ``-Xptxas -v`` output whose name matches ``pattern``,
    demangled where c++filt is at hand."""
    entries, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            entries.append((name, int(m.group(1)), *spills))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in entries), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(entries):     # "void (anonymous namespace)::f<..>(..)"
        entries = [(n.replace("(anonymous namespace)::", "").split("(")[0]
                    .split(" ", 1)[-1], *e[1:]) for n, e in zip(names, entries)]
    return [e for e in entries if re.search(pattern, e[0])]


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(torch, got, want, tol, what) -> float:
    """max |got - want|; fails unless allclose at atol = rtol = tol."""
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
          f"{what}: kernel vs plain max |err| {err}")
    return err


def ssd_cost(Bsz, L, H, hd, N, *, groups=1, T=64, state=True):
    """(bytes, float32 operations) of the SSD scan on these shapes: each
    input read once (B and C as ``groups`` groups, one on zamba2's layout,
    where every head reads the same rows) and y (and the final state)
    written once; the chunked
    form at the kernel's tile of T tokens, causal and unpadded: per chunk
    of n tokens C B^T and M X over the n(n+1)/2 causal pairs, C . state and
    the state update over n x N x hd."""
    ops = 0
    for c0 in range(0, L, T):
        n = min(T, L - c0)
        tri = n * (n + 1) // 2
        ops += 2 * tri * N + 2 * tri * hd + 2 * 2 * n * N * hd
    elems = (2 * Bsz * L * H * hd + Bsz * L * H + H
             + 2 * Bsz * L * groups * N
             + (Bsz * H * hd * N if state else 0))
    return 4 * elems, ops * Bsz * H


def ssd_inputs(torch, g, Bsz, L, H=80, hd=64, N=64):
    """K7's inputs as zamba2-2.7b's Mamba2 hands them over: float32, dt a
    softplus, A = -linspace(1, 16, H) (the init), one B/C group expanded
    over the heads (a view with a head stride of 0)."""
    dev = torch.device("cuda")
    x = torch.randn(Bsz, L, H, hd, generator=g, device=dev)
    dt = torch.nn.functional.softplus(torch.randn(Bsz, L, H, generator=g,
                                                  device=dev))
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm, C = (torch.randn(Bsz, L, 1, N, generator=g, device=dev)
             .expand(Bsz, L, H, N) for _ in range(2))
    return x, dt, A, Bm, C


# the closed control loop, LoopConfig(): 4 slots, max_seq 48, a first
# prefill chunk of 8 tokens (16-token prompts, 8 generated), 14 ticks of 10
# router steps; its write-instance checks write key 0 and key 47 in each
# regime; torch.profiler records the router steps of tick 5 (the spike)
LOOP_TICKS, LOOP_SLOTS, LOOP_MAX_SEQ, LOOP_CHUNK = 14, 4, 48, 8
LOOP_WRITE_INDICES = {"fresh": [0, 17, 47, 9],
                      "wrapped": [48, 95, 101, 68],
                      "mixed": [0, 53, 47, 143]}
LOOP_PROFILED = (5, 5)
# the allocator's DQN, card against CPU
DQN_TOL, DQN_STEPS, DQN_TRANSITIONS = 1e-4, 10, 256
SAMPLE_SHAPES = {"qwen2.5-3b": (8, 151936), "zamba2-2.7b": (8, 32000),
                 "olmoe-1b-7b": (8, 50304), "falcon-mamba-7b": (8, 65024),
                 "qwen2-vl-7b": (8, 152064),
                 "seamless-m4t-medium": (8, 256206),
                 "qwen2.5-3b loop": (LOOP_SLOTS, 151936)}
SSD_LENGTHS = (64, 200, 2048)


def sample_rows(torch, ops, ref, sample_noise, g):
    """K3 at every served model's vocabulary (SAMPLE_SHAPES: 8 rows, and
    the closed loop's 4 at qwen2.5-3b's):
    greedy tokens bitwise equal to the plain version and to torch.argmax (a
    tie across a split boundary goes to the first index), hash bits
    bitwise, noise within 1e-6, the sampled token the Gumbel max; timed
    greedy beside the plain version and torch.argmax.  Returns qwen's row
    with the others under "others"."""
    from repro_torch.kernels.sample import split_plan
    from repro_torch.kernels._lib import sm_count
    dev = torch.device("cuda")
    out = {}
    for arch, (B, V) in SAMPLE_SHAPES.items():
        split_len, n_splits = split_plan(B, V, sm_count(0))
        logits = torch.randn(B, V, generator=g, device=dev)
        k = split_len * (n_splits // 2)              # a split boundary
        logits[0, [k, k - 1, V - 3]] = logits[0].max() + 1.0
        seed = torch.arange(B, dtype=torch.int32, device=dev) * 7919 - 3
        rid = torch.arange(B, dtype=torch.int32, device=dev) + 100
        pos = torch.arange(B, dtype=torch.int32, device=dev) * 13
        greedy = torch.zeros(B, device=dev)
        got = ops.fused_sample(logits, seed, rid, pos, greedy)
        check(torch.equal(got, ref.fused_sample_ref(logits, seed, rid, pos,
                                                    greedy)),
              f"fused_sample (greedy, V {V}): kernel != plain")
        check(torch.equal(got, torch.argmax(logits, dim=1).to(torch.int32)),
              f"fused_sample (greedy, V {V}): kernel != torch.argmax")
        check(int(got[0]) == k - 1,
              f"fused_sample (V {V}): tie not broken to the first index")
        bits, noise = sample_noise(seed, rid, pos, V)
        want_bits = ref.sample_bits(seed.cpu(), rid.cpu(), pos.cpu(), V)
        check(torch.equal(bits.cpu(), want_bits), "sample hash bits differ")
        want_noise = ref.gumbel_noise(want_bits)
        check(torch.allclose(noise.cpu(), want_noise, rtol=NOISE_TOL,
                             atol=NOISE_TOL), "Gumbel noise differs")
        temp = torch.full((B,), 0.7, device=dev)
        got_t = ops.fused_sample(logits, seed, rid, pos, temp)
        check(torch.equal(got_t, ops.fused_sample(logits, seed, rid, pos,
                                                  temp)),
              "fused_sample (temperature): two identical calls differ")
        score = logits.float() / 0.7 + want_noise.to(dev)
        best = score.max(dim=1).values
        at_got = score.gather(1, got_t.long()[:, None])[:, 0]
        # equal token, or a near-tie that a last-ulp difference in g can flip
        check(bool(torch.all(at_got >= best - 1e-5 * best.abs())),
              "fused_sample (temperature): kernel token is not the Gumbel max")
        row = dict(
            max_abs_err=0.0,
            ms=timed_ms(torch, lambda: ops.fused_sample(logits, seed, rid,
                                                        pos, greedy)),
            plain_ms=timed_ms(torch, lambda: ref.fused_sample_ref(
                logits, seed, rid, pos, greedy)),
            library_ms=timed_ms(torch, lambda: torch.argmax(logits, dim=1)),
            shape=f"logits ({B},{V}) f32, greedy, {n_splits} splits of "
                  f"{split_len}")
        row["bound_ms"], row["bound_by"] = bound(B * V * 4 + B * 20, B * V,
                                                 PEAK_F32_S)
        out[arch] = row
    qwen = out.pop("qwen2.5-3b")
    qwen["others"] = out
    return qwen


def ssd_rows(torch, ops, ref, g):
    """K7 held against its plain version at (1, 200) and (2, 256), both y
    and the final state, two identical calls bitwise equal; then timed with
    the final state at (1, L) for L in SSD_LENGTHS.  Returns the (1, 200)
    row with the others under "others".  The bound: the larger of the
    bytes and the 3xTF32 products at the tensor cores' TF32 rate."""
    errs = []
    for Bsz, L in ((1, 200), (2, 256)):
        args = ssd_inputs(torch, g, Bsz, L)
        y, h = ops.ssm_scan(*args, return_state=True)
        want_y, want_h = ref.ssm_scan_ref(*args, return_state=True)
        errs.append(max_err(torch, y, want_y, SSM_TOL,
                            f"ssm_scan y ({Bsz}, {L})"))
        errs.append(max_err(torch, h, want_h, SSM_TOL,
                            f"ssm_scan final state ({Bsz}, {L})"))
        check(torch.equal(ops.ssm_scan(*args), y),
              "ssm_scan: y differs without return_state")
        y2, h2 = ops.ssm_scan(*args, return_state=True)
        check(torch.equal(y, y2) and torch.equal(h, h2),
              f"ssm_scan ({Bsz}, {L}): two identical calls differ")
    rows = {}
    for L in SSD_LENGTHS:
        args = ssd_inputs(torch, g, 1, L)
        y, h = ops.ssm_scan(*args, return_state=True)
        want_y, want_h = ref.ssm_scan_ref(*args, return_state=True)
        err = max(max_err(torch, y, want_y, SSM_TOL, f"ssm_scan y (1, {L})"),
                  max_err(torch, h, want_h, SSM_TOL,
                          f"ssm_scan final state (1, {L})"))
        nbytes, flops = ssd_cost(1, L, 80, 64, 64)
        row = dict(
            max_abs_err=max(errs + [err]),
            ms=timed_ms(torch, lambda: ops.ssm_scan(*args,
                                                    return_state=True)),
            plain_ms=timed_ms(torch, lambda: ref.ssm_scan_ref(
                *args, return_state=True), reps=5, warmup=1),
            library_ms=None,      # no PyTorch call computes an SSD scan
            shape=f"x (1,{L},80,64), dt (1,{L},80), B/C (1,{L},1,64) "
                  f"expanded to 80 heads, f32, with the final state")
        row["bound_ms"], row["bound_by"] = bound(nbytes, 3 * flops,
                                                 PEAK_TF32_S)
        rows[L] = row
    main = rows.pop(200)
    main["others"] = {f"L={L}": r for L, r in rows.items()}
    return main


def write_indices(Smax):
    """Index rows of the write instances' checks, 8 rows each: every row
    below Smax, every row wrapped past it, and mixed.  Each regime writes
    key 0 (the first split) and key Smax - 1 (the last split)."""
    return {
        "fresh": [0, 5, 63, 64, 200, 511, Smax - 1, 77],
        "wrapped": [Smax, Smax + 63, 2 * Smax + 5, 3 * Smax - 1, Smax + 640,
                    4 * Smax + 1, 2 * Smax + 200, Smax + 77],
        "mixed": [0, Smax + 5, 200, 3 * Smax - 1, 640, Smax, 77,
                  2 * Smax + 300]}


def write_instance_row(torch, ops, ref, g, label, H, KV, hd, paged,
                       Smax=1024, B=8, indices=None):
    """K1's write instance (``decode_attention_write``), or K5's through a
    shuffled table over a pool of B · Smax / 8 + 1 blocks of 8 (``paged``),
    at (B, H, KV, hd), bf16 caches, index rows ``indices`` (default
    ``write_indices(Smax)``): in each index regime with bf16
    new rows, and mixed with float32 new rows, the output and both caches
    bitwise equal to the unfused kernels K2, K2, K1 (K6, K6, K5), the
    caches equal to the plain composition and the output within ATTN_TOL
    of it.  Timed, mixed regime: the write instance, K1 (K5) alone, the
    unfused three and the plain composition.  Bound: K1's (K5's) bytes and
    operations plus the new rows read and written into both caches.  No
    single PyTorch call writes and attends: library_ms is None."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    bk = 8
    nk = Smax // bk
    indices = indices or write_indices(Smax)
    randn = lambda *shape, dtype=bf16: torch.randn(
        *shape, generator=g, device=dev).to(dtype)
    q = randn(B, 1, H, hd)
    if paged:
        k0, v0 = randn(B * nk + 1, bk, KV, hd), randn(B * nk + 1, bk, KV, hd)
        tbl = (1 + torch.randperm(B * nk, generator=g, device=dev)).reshape(
            B, nk).to(torch.int32)
    else:
        k0, v0 = randn(B, Smax, KV, hd), randn(B, Smax, KV, hd)

    def fused(kn, vn, kc, vc, idx):
        if paged:
            return ops.decode_attention_paged_write(q, kn, vn, kc, vc, tbl,
                                                    idx)
        return ops.decode_attention_write(q, kn, vn, kc, vc, idx)

    def alone(kc, vc, idx):
        if paged:
            return ops.decode_attention_paged(q, kc, vc, tbl, idx)
        return ops.decode_attention(q, kc, vc, idx)

    def unfused(kn, vn, kc, vc, idx):       # what decode ran before
        if paged:
            rpos = torch.remainder(idx, Smax)
            blk = tbl[torch.arange(B, device=dev), (rpos // bk).long()]
            ops.cache_paged_update(kc, kn, blk, rpos % bk)
            ops.cache_paged_update(vc, vn, blk, rpos % bk)
        else:
            slot = torch.remainder(idx, Smax)
            ops.cache_ring_update(kc, kn, slot)
            ops.cache_ring_update(vc, vn, slot)
        return alone(kc, vc, idx)

    def plain(kn, vn, kc, vc, idx):
        if paged:
            return ref.decode_attention_paged_write_ref(q, kn, vn, kc, vc,
                                                        tbl, idx)
        return ref.decode_attention_write_ref(q, kn, vn, kc, vc, idx)

    name = "decode_attention_paged_write" if paged else \
        "decode_attention_write"
    errs = []
    cases = [(r, bf16) for r in ("fresh", "wrapped", "mixed")] + [
        ("mixed", torch.float32)]
    for regime, new_dt in cases:
        idx = torch.tensor(indices[regime], dtype=torch.int32, device=dev)
        kn, vn = randn(B, KV, hd, dtype=new_dt), randn(B, KV, hd,
                                                       dtype=new_dt)
        what = f"{name} [{label}, {regime}, new {new_dt}]"
        kf, vf = k0.clone(), v0.clone()
        out = fused(kn, vn, kf, vf, idx)
        ku, vu = k0.clone(), v0.clone()
        check(torch.equal(out, unfused(kn, vn, ku, vu, idx)),
              f"{what}: output != the unfused kernels'")
        check(torch.equal(kf, ku) and torch.equal(vf, vu),
              f"{what}: caches != the unfused kernels'")
        kp_, vp_ = k0.clone(), v0.clone()
        want = plain(kn, vn, kp_, vp_, idx)
        check(torch.equal(kf, kp_) and torch.equal(vf, vp_),
              f"{what}: caches != the plain composition's")
        errs.append(max_err(torch, out, want, ATTN_TOL, what))
    idx = torch.tensor(indices["mixed"], dtype=torch.int32, device=dev)
    kn, vn = randn(B, KV, hd), randn(B, KV, hd)
    kc, vc = k0.clone(), v0.clone()
    live_b = torch.clamp(idx + 1, max=Smax)
    live = live_b.sum().item()
    blocks = ((live_b + bk - 1) // bk).sum().item() if paged else 0
    nbytes = (2 * B * H * hd * 2 + 2 * live * KV * hd * 2 + blocks * 4 + B * 4
              + 2 * B * KV * hd * (2 + 2))
    row = dict(
        max_abs_err=max(errs),
        ms=timed_ms(torch, lambda: fused(kn, vn, kc, vc, idx)),
        alone_ms=timed_ms(torch, lambda: alone(kc, vc, idx)),
        unfused_ms=timed_ms(torch, lambda: unfused(kn, vn, kc, vc, idx)),
        plain_ms=timed_ms(torch, lambda: plain(kn, vn, kc, vc, idx)),
        library_ms=None,
        shape=f"{label}: q ({B},1,{H},{hd}), "
              + (f"pool ({B * nk + 1},8,{KV},{hd}), shuffled table "
                 f"({B},{nk})" if paged else f"caches ({B},{Smax},{KV},{hd})")
              + f" bf16, new ({B},{KV},{hd}), index mixed and wrapped")
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * live * H * hd,
                                             PEAK_BF16_S)
    print(f"  {name} {row['shape']}: write instance {row['ms']:.4f} ms, "
          f"{'K5' if paged else 'K1'} alone {row['alone_ms']:.4f} ms, "
          f"unfused ({'K6, K6, K5' if paged else 'K2, K2, K1'}) "
          f"{row['unfused_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), max|err| "
          f"{row['max_abs_err']}; bitwise equal to the unfused kernels in "
          f"{len(cases)} cases")
    return row


# --------------------------------------------------------------------- phase 2


def kernel_phase(torch, ops, ref, sample_noise):
    F = torch.nn.functional
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def attn_err(got, want, what):
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=ATTN_TOL,
                            rtol=ATTN_TOL)
        check(ok, f"{what}: kernel vs plain max |err| {err}")
        return err

    def sdpa_ms(q, k, v, mask=None, causal=False):
        """One library call on the same inputs, as (B, H, S, hd) views."""
        return timed_ms(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=causal, enable_gqa=True))

    # K2: ring-slot write, 8 slots, KV 2, hd 128, Smax 1024
    B, Smax, KV, hd = 8, 1024, 2, 128
    cache = randn(B, Smax, KV, hd)
    new = randn(B, KV, hd)
    slot = torch.tensor([0, 5, 200, 511, 1023, 0, 952, 77], dtype=torch.int32,
                        device=dev)
    want = ref.cache_ring_update_ref(cache.clone(), new, slot)
    got = ops.cache_ring_update(cache.clone(), new, slot)
    check(torch.equal(got, want), "cache_ring_update: kernel != plain")
    rows_idx = torch.arange(B, device=dev)
    slot_l = slot.long()

    def lib_k2():
        cache[rows_idx, slot_l] = new

    nbytes = B * KV * hd * 2 * 2 + B * 4
    rows["cache_ring_update"] = dict(
        max_abs_err=0.0,
        ms=timed_ms(torch, lambda: ops.cache_ring_update(cache, new, slot)),
        plain_ms=timed_ms(torch, lambda: ref.cache_ring_update_ref(
            cache, new, slot)),
        library_ms=timed_ms(torch, lib_k2),
        shape="cache (8,1024,2,128) bf16, new (8,2,128)")
    rows["cache_ring_update"]["bound_ms"], rows["cache_ring_update"][
        "bound_by"] = bound(nbytes, 0, PEAK_BF16_S)

    # K1: decode attention; qwen2.5-3b (H 16, KV 2, hd 128, Smax 1024) and
    # h2o-danube (H 32, KV 8, hd 80, Smax = window 4096), mixed + wrapped
    errs, k1 = [], {}
    for name, (H, KV, hd, Smax) in {"qwen": (16, 2, 128, 1024),
                                    "danube": (32, 8, 80, 4096)}.items():
        q = randn(B, 1, H, hd)
        kc, vc = randn(B, Smax, KV, hd), randn(B, Smax, KV, hd)
        index = torch.tensor([0, 5, 200, Smax - 1, Smax, 3 * Smax + 7, 640,
                              77], dtype=torch.int32, device=dev)
        got = ops.decode_attention(q, kc, vc, index)
        want = ref.decode_attention_ref(q, kc, vc, index)
        errs.append(attn_err(got, want, f"decode_attention[{name}]"))
        if name == "qwen":
            live = torch.clamp(index + 1, max=Smax).sum().item()
            nbytes = 2 * B * H * hd * 2 + 2 * live * KV * hd * 2 + B * 4
            flops = 4 * live * H * hd
            mask = (torch.arange(Smax, device=dev)[None, :]
                    <= index[:, None])[:, None, None, :]
            k1 = dict(
                ms=timed_ms(torch, lambda: ops.decode_attention(
                    q, kc, vc, index)),
                plain_ms=timed_ms(torch, lambda: ref.decode_attention_ref(
                    q, kc, vc, index)),
                library_ms=sdpa_ms(q, kc, vc, mask=mask),
                shape="q (8,1,16,128), caches (8,1024,2,128) bf16, index "
                      "mixed and wrapped")
            k1["bound_ms"], k1["bound_by"] = bound(nbytes, flops,
                                                   PEAK_BF16_S)
    rows["decode_attention"] = dict(max_abs_err=max(errs), **k1)

    # K5: paged decode attention at the paged serve's shapes: q (8,1,16,128),
    # a pool of 8 * 128 + 1 blocks of 8 (block 0 the trash block), a
    # shuffled table, mixed and wrapped indices
    H, KV, hd, bk, nk = 16, 2, 128, 8, 128
    NB, Smax = B * nk + 1, nk * bk
    q = randn(B, 1, H, hd)
    kp, vp = randn(NB, bk, KV, hd), randn(NB, bk, KV, hd)
    tbl = (1 + torch.randperm(B * nk, generator=g, device=dev)).reshape(
        B, nk).to(torch.int32)
    index = torch.tensor([0, 5, 200, Smax - 1, Smax, 3 * Smax + 7, 640, 77],
                         dtype=torch.int32, device=dev)
    got = ops.decode_attention_paged(q, kp, vp, tbl, index)
    want = ref.decode_attention_paged_ref(q, kp, vp, tbl, index)
    err = attn_err(got, want, "decode_attention_paged")
    # K5 == K1 bitwise under an identity table (same split plan and tiles)
    kc, vc = randn(B, Smax, KV, hd), randn(B, Smax, KV, hd)
    ident = torch.arange(B * nk, dtype=torch.int32, device=dev).reshape(B, nk)
    check(torch.equal(ops.decode_attention(q, kc, vc, index),
                      ops.decode_attention_paged(
                          q, kc.reshape(B * nk, bk, KV, hd),
                          vc.reshape(B * nk, bk, KV, hd), ident, index)),
          "decode_attention_paged != decode_attention under an identity "
          "table")
    # two identical calls give bitwise-equal outputs (no atomics)
    check(torch.equal(ops.decode_attention(q, kc, vc, index),
                      ops.decode_attention(q, kc, vc, index)),
          "decode_attention: two identical calls differ")
    check(torch.equal(ops.decode_attention_paged(q, kp, vp, tbl, index),
                      ops.decode_attention_paged(q, kp, vp, tbl, index)),
          "decode_attention_paged: two identical calls differ")
    live_b = torch.clamp(index + 1, max=Smax)
    live = live_b.sum().item()
    blocks = ((live_b + bk - 1) // bk).sum().item()
    # q in, out, the live K/V rows, the table entries they need, the index
    nbytes = 2 * B * H * hd * 2 + 2 * live * KV * hd * 2 + blocks * 4 + B * 4
    # yardstick: one library attention over a view gathered beforehand
    # (no single PyTorch call attends through a block table)
    kg = kp[tbl.long()].reshape(B, Smax, KV, hd)
    vg = vp[tbl.long()].reshape(B, Smax, KV, hd)
    mask = (torch.arange(Smax, device=dev)[None, :]
            <= index[:, None])[:, None, None, :]
    rows["decode_attention_paged"] = dict(
        max_abs_err=err,
        ms=timed_ms(torch, lambda: ops.decode_attention_paged(
            q, kp, vp, tbl, index)),
        plain_ms=timed_ms(torch, lambda: ref.decode_attention_paged_ref(
            q, kp, vp, tbl, index)),
        library_ms=sdpa_ms(q, kg, vg, mask=mask),
        shape="q (8,1,16,128), pool (1025,8,2,128) bf16, shuffled table "
              "(8,128), index mixed and wrapped; library = SDPA over a "
              "pre-gathered view")
    rows["decode_attention_paged"]["bound_ms"], rows[
        "decode_attention_paged"]["bound_by"] = bound(
        nbytes, 4 * live * H * hd, PEAK_BF16_S)

    # K6: paged write into that pool, distinct (blk, off) targets, exact in
    # f32 and bf16 (new rows in f32 and bf16)
    blk = torch.tensor([1, 1024, 7, 500, 33, 1, 900, 64], dtype=torch.int32,
                       device=dev)
    off = torch.tensor([0, 7, 3, 5, 1, 6, 2, 4], dtype=torch.int32,
                       device=dev)
    for dt in (torch.float32, bf16):
        for new_dt in (torch.float32, bf16):
            pool = randn(NB, bk, KV, hd, dtype=dt)
            new = randn(B, KV, hd, dtype=new_dt)
            want = ref.cache_paged_update_ref(pool.clone(), new, blk, off)
            ops.cache_paged_update(pool, new, blk, off)
            check(torch.equal(pool, want),
                  f"cache_paged_update {dt}/{new_dt}: kernel != plain")
    new = randn(B, KV, hd)
    blk_l, off_l = blk.long(), off.long()

    def lib_k6():
        kp[blk_l, off_l] = new

    rows["cache_paged_update"] = dict(
        max_abs_err=0.0,
        ms=timed_ms(torch, lambda: ops.cache_paged_update(kp, new, blk, off)),
        plain_ms=timed_ms(torch, lambda: ref.cache_paged_update_ref(
            kp, new, blk, off)),
        library_ms=timed_ms(torch, lib_k6),
        shape="pool (1025,8,2,128) bf16, new (8,2,128)")
    rows["cache_paged_update"]["bound_ms"], rows["cache_paged_update"][
        "bound_by"] = bound(B * KV * hd * 2 * 2 + B * 8, 0, PEAK_BF16_S)

    # K4: flash attention (prefill); qwen2.5-3b at Sq 64 and a ragged 200,
    # h2o-danube (hd 80) with its 4096 window and with a short window 64,
    # and hd 8 and 16 (the smoke configs' widths: the tensor-core body pads
    # them to 16 in shared memory)
    errs, k4 = [], {}
    for name, (S, H, KV, hd, window) in {
            "qwen200": (200, 16, 2, 128, None), "qwen64": (64, 16, 2, 128, None),
            "danube": (200, 32, 8, 80, 4096),
            "danube_w64": (200, 32, 8, 80, 64),
            "hd8": (200, 16, 2, 8, None), "hd16": (37, 4, 2, 16, 16)}.items():
        q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        errs.append(attn_err(got, want, f"flash_attention[{name}]"))
        if name == "qwen200":
            pairs = S * (S + 1) // 2
            nbytes = (2 * S * H * hd + 2 * S * KV * hd) * 2
            k4 = dict(
                ms=timed_ms(torch, lambda: ops.flash_attention(
                    q, k, v, causal=True)),
                plain_ms=timed_ms(torch, lambda: ref.flash_attention_ref(
                    q, k, v, causal=True)),
                library_ms=sdpa_ms(q, k, v, causal=True),
                shape="q (1,200,16,128), k/v (1,200,2,128) bf16, causal")
            k4["bound_ms"], k4["bound_by"] = bound(nbytes, 4 * pairs * H * hd,
                                                   PEAK_BF16_S)
    rows["flash_attention"] = dict(max_abs_err=max(errs), **k4)

    # K3: fused sampling over qwen2.5-3b's 151,936-token vocabulary (the
    # kernels line) and zamba2-2.7b's 32,000
    rows["fused_sample"] = sample_rows(torch, ops, ref, sample_noise, g)

    # K7: the SSD scan at zamba2-2.7b's prefill (80 heads, hd 64, N 64): a
    # ragged 200-token prompt and an aligned batch of two of 256, y and the
    # final state (the prefill always asks for it); then timed at the
    # chunked prefill's one chunk (64), the unchunked prompt (200, the
    # kernels line) and a long prompt (2048)
    rows["ssm_scan"] = ssd_rows(torch, ops, ref, g)
    for name, r in rows.items():
        for label, rr in {"": r, **r.get("others", {})}.items():
            print(f"  {name}{' ' + label if label else ''}: {rr['shape']}: "
                  f"kernel {rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} ms, "
                  f"library {rr['library_ms']} ms, bound "
                  f"{rr['bound_ms']:.5f} ms ({rr['bound_by']}), max|err| "
                  f"{rr['max_abs_err']}")
    # K1 and K5 with the row write folded in, at the qwen2.5-3b shapes above
    for paged in (False, True):
        row = write_instance_row(torch, ops, ref, g, "qwen2.5-3b", 16, 2, 128,
                                 paged)
        rows["decode_attention_paged_write" if paged
             else "decode_attention_write"] = row
    return rows


def attention_shapes_phase(torch, ops, ref, label, H, KV, hd, seed,
                           Smax=1024, S=200):
    """K1, K2, K4, K5 and K6 at another model's attention shapes, 8 slots:
    zamba2's shared attention (32 heads, 32 KV heads, hd 80), olmoe-1b-7b
    (16 heads, 16 KV heads, hd 128) and seamless-m4t-medium's decoder (16
    heads, 16 KV heads, hd 64), all G = 1, max_seq 1024, prompts of 200
    tokens; qwen2-vl-7b (28 heads over 4 KV heads, G = 7, hd 128), max_seq
    2048, prompts of 1224 tokens.  Decode rows sit near S tokens, K4 runs
    one S-token prompt.  In bf16: held against their plain versions and
    timed as in kernel_phase; then the write instances of K1 and K5 there.
    Printed; the kernels line keeps the qwen2.5-3b shapes."""
    F = torch.nn.functional
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    B, bk = 8, 8
    nk = Smax // bk
    randn = lambda *shape: torch.randn(*shape, generator=g,
                                       device=dev).to(bf16)
    index = S + 2 * torch.arange(B, dtype=torch.int32, device=dev)
    live = (index + 1).sum().item()
    mask = (torch.arange(Smax, device=dev)[None, :]
            <= index[:, None])[:, None, None, :]
    q = randn(B, 1, H, hd)
    kc, vc = randn(B, Smax, KV, hd), randn(B, Smax, KV, hd)
    NB = B * nk + 1
    kp, vp = randn(NB, bk, KV, hd), randn(NB, bk, KV, hd)
    tbl = (1 + torch.randperm(B * nk, generator=g, device=dev)).reshape(
        B, nk).to(torch.int32)
    kg = kp[tbl.long()].reshape(B, Smax, KV, hd)
    vg = vp[tbl.long()].reshape(B, Smax, KV, hd)
    new = randn(B, KV, hd)
    rows_idx, slot_l = torch.arange(B, device=dev), index.long()
    blk = tbl[rows_idx, slot_l // bk]
    off = (index % bk).to(torch.int32)
    qs, ks, vs = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
    blocks = ((index + bk) // bk).sum().item()
    sdpa = lambda q_, k_, v_, **kw: F.scaled_dot_product_attention(
        q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
        enable_gqa=H != KV, **kw)

    def lib_k2():
        kc[rows_idx, slot_l] = new

    def lib_k6():
        kp[blk.long(), off.long()] = new

    cases = {
        "decode_attention": (
            lambda: ops.decode_attention(q, kc, vc, index),
            lambda: ref.decode_attention_ref(q, kc, vc, index),
            lambda: sdpa(q, kc, vc, attn_mask=mask),
            2 * B * H * hd * 2 + 2 * live * KV * hd * 2 + B * 4,
            4 * live * H * hd, False),
        "cache_ring_update": (
            lambda: ops.cache_ring_update(kc, new, index),
            lambda: ref.cache_ring_update_ref(kc, new, index), lib_k2,
            B * KV * hd * 2 * 2 + B * 4, 0, True),
        "flash_attention": (
            lambda: ops.flash_attention(qs, ks, vs, causal=True),
            lambda: ref.flash_attention_ref(qs, ks, vs, causal=True),
            lambda: sdpa(qs, ks, vs, is_causal=True),
            (2 * S * H * hd + 2 * S * KV * hd) * 2,
            4 * (S * (S + 1) // 2) * H * hd, False),
        "decode_attention_paged": (
            lambda: ops.decode_attention_paged(q, kp, vp, tbl, index),
            lambda: ref.decode_attention_paged_ref(q, kp, vp, tbl, index),
            lambda: sdpa(q, kg, vg, attn_mask=mask),
            2 * B * H * hd * 2 + 2 * live * KV * hd * 2 + blocks * 4 + B * 4,
            4 * live * H * hd, False),
        "cache_paged_update": (
            lambda: ops.cache_paged_update(kp, new, blk, off),
            lambda: ref.cache_paged_update_ref(kp, new, blk, off), lib_k6,
            B * KV * hd * 2 * 2 + B * 8, 0, True),
    }
    for name, (kernel, plain, library, nbytes, flops, exact) in cases.items():
        if exact:    # the writes land in the caches: compare copies
            cache = kc if name == "cache_ring_update" else kp
            before = cache.clone()
            kernel()
            got = cache.clone()
            cache.copy_(before)
            plain()
            check(torch.equal(got, cache), f"{name} [{label}]: kernel != "
                                           f"plain")
            err = 0.0
        else:
            err = max_err(torch, kernel(), plain(), ATTN_TOL,
                          f"{name} [{label}]")
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_S)
        where = f" (1,{S},{H},{hd})" if name == "flash_attention" else ""
        print(f"  {label} {name}{where}: kernel {timed_ms(torch, kernel):.4f} "
              f"ms, plain {timed_ms(torch, plain):.4f} ms, library "
              f"{timed_ms(torch, library):.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}), max|err| {err}")
    for paged in (False, True):
        write_instance_row(torch, ops, ref, g, label, H, KV, hd, paged, Smax)


# --------------------------------------------------------------------- phase 3


def decoder_launches(n_layers):
    """A decoder model's launch counts (qwen2.5-3b's 36 layers,
    olmoe-1b-7b's 16): per layer one K1 write instance a dense tick (or one
    K5 write instance a paged lane), each carrying the layer's two row
    writes; one K4 per layer a prefilled admission, one K3 a fused tick.
    The standalone K1, K2, K5 and K6 launch 0 times."""
    def launches(ticks, prefilled, lanes=0, fused=None):
        return {"decode_attention": 0, "cache_ring_update": 0,
                "fused_sample": ticks if fused is None else fused,
                "flash_attention": n_layers * prefilled,
                "decode_attention_paged": 0, "cache_paged_update": 0,
                "ssm_scan": 0, "decode_attention_write": n_layers * ticks,
                "decode_attention_paged_write": n_layers * lanes}
    return launches


def zamba2_launches(ticks, prefilled, paged=False):
    """zamba2-2.7b's: one K7 per Mamba2 layer and one K4 per group a
    prefilled admission; per group one K1 write instance (or one K5 write
    instance paged) a tick, carrying two row writes; one K3 a tick (every
    tick is fused: no speculation).  The standalone K1, K2, K5 and K6
    launch 0 times."""
    dense_ticks, paged_ticks = (0, ticks) if paged else (ticks, 0)
    return {"decode_attention": 0, "cache_ring_update": 0,
            "fused_sample": ticks, "flash_attention": Z_ATTN * prefilled,
            "decode_attention_paged": 0, "cache_paged_update": 0,
            "ssm_scan": Z_MAMBA * prefilled,
            "decode_attention_write": Z_ATTN * dense_ticks,
            "decode_attention_paged_write": Z_ATTN * paged_ticks}


def mamba1_launches(ticks, prefilled):
    """falcon-mamba-7b's: one K3 a tick (every tick is fused: recurrent
    state cannot rewind, so nothing is speculated) and nothing else: the
    model has no attention, and Mamba1's scan is no kernel of the JAX
    package."""
    return {**{name: 0 for name in KERNEL_INFO}, "fused_sample": ticks}


def check_launches(counts, want, what):
    """The exact counts, and in so many words: no standalone row write (or
    unfused K1/K5) ran on a serving path; each write instance launch
    carried two row writes."""
    rows = 2 * (counts["decode_attention_write"]
                + counts["decode_attention_paged_write"])
    print(f"    launches {counts}; row writes carried in the write "
          f"instances: {rows}")
    check(all(counts[k] == 0 for k in ROW_WRITES_ALONE),
          f"{what}: a standalone row write or unfused decode ran: {counts}")
    check(counts == want, f"{what}: launch counts {counts}, expected {want}")


def serve_phase(torch, ops, serve, base_argv, expected):
    """The serve CLI at full width, unchunked and chunked by 64; launch
    counts must equal ``expected(ticks, admissions)``."""
    launches = {name: 0 for name in ops.KERNELS}
    for chunk in (None, 64):
        argv = base_argv + ([] if chunk is None else
                            ["--prefill-chunk", str(chunk)])
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        print(f"  serve {' '.join(argv)}  ({wall:.1f} s with weight init, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
        print("    " + text.strip().replace("\n", "\n    "))
        check(rc == 0, f"serve exited {rc}")
        m = re.search(r"ticks=(\d+) admissions=(\d+) logits_pulls=(\d+) "
                      r"finished=(\d+)", text)
        check(m is not None, "serve printed no tick summary")
        ticks, admissions, pulls, finished = map(int, m.groups())
        check(finished == 8, f"{finished}/8 requests finished")
        check(admissions == 8, f"{admissions} admissions for 8 requests")
        check(pulls == 0, f"greedy serving pulled logits {pulls} times")
        check_launches(counts, expected(ticks, admissions), "serve")
        for name in launches:
            launches[name] += counts[name]
        free(torch)
    return launches


def run_shared(eng, prompts):
    """Request 0 alone until it has streamed past the shared prefix (a
    VLM's patch positions and PREFIX_LEN tokens; its prefix blocks are then
    registered), then the other seven; run to the end and return the
    greedy streams by request id."""
    import numpy as np
    from repro_torch.serving import Request
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), gen_len=GEN_LEN)
            for i, p in enumerate(prompts)]
    eng.submit(reqs[0], now=0.0)
    done, step = [], 0
    while eng.pos[0] < eng.cfg.n_vision_patches + PREFIX_LEN:
        step += 1
        done.extend(eng.step(now=float(step)))
    for r in reqs[1:]:
        eng.submit(r, now=float(step))
    while len(done) < len(reqs):
        step += 1
        check(step < 5000, "the shared-prefix run did not finish")
        done.extend(eng.step(now=float(step)))
    return {r.rid: list(r.tokens_out) for r in done}


def shared_prompts(core):
    """Prefix + tail_i + Y_i + Y_i, Y_i the 16 tokens a plain greedy run
    generates after prefix + tail_i (drafts then find their n-grams).  A
    VLM's prompts open with the same patch positions (token ids drawn from
    a seed of their own; the patches replace their embeddings)."""
    import numpy as np
    from repro_torch.serving import Request, ServingEngine
    rng = np.random.default_rng(1)
    vocab = core.cfg.vocab
    prefix = rng.integers(3, vocab, PREFIX_LEN)
    prefix = np.concatenate([np.random.default_rng(4).integers(
        3, vocab, core.cfg.n_vision_patches), prefix])
    bases = [np.concatenate([prefix, rng.integers(3, vocab, TAIL_LEN)])
             .astype(np.int32) for _ in range(SLOTS)]
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=core.max_seq,
                        core=core)
    reqs = [Request(rid=i, prompt=b, gen_len=GEN_LEN)
            for i, b in enumerate(bases)]
    for r in reqs:
        eng.submit(r, now=0.0)
    done = []
    while len(done) < len(reqs):
        done.extend(eng.step(now=0.0))
    ys = {r.rid: np.asarray(r.tokens_out, np.int32) for r in done}
    return [np.concatenate([b, ys[i], ys[i]]) for i, b in enumerate(bases)]


@contextlib.contextmanager
def counted_steps(core):
    """Count the engine's fused ticks and verify lanes (a verify tick of
    window W decodes W lanes) by wrapping its step functions."""
    calls = {"fused": 0, "verify": 0, "lanes": 0}
    fused, verify = core.fused_decode, core.verify

    def fused_counted(*args):
        calls["fused"] += 1
        return fused(*args)

    def verify_counted(params, tokens, cache):
        calls["verify"] += 1
        calls["lanes"] += tokens.shape[1]
        return verify(params, tokens, cache)

    core.fused_decode, core.verify = fused_counted, verify_counted
    try:
        yield calls
    finally:
        core.fused_decode, core.verify = fused, verify


def paged_serve_phase(torch, ops, core, prompts, hold_accepted=True):
    """ServingEngine(pool="paged", spec_k=3) at full width: prefix sharing
    and speculative verify on; K5's write instance carries every decoded
    lane, K1's none.  Drafts must be proposed, and accepted unless
    ``hold_accepted`` is False (then the count is printed)."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.slots import pool_geometry
    bk = pool_geometry(SLOTS, core.max_seq)[0]
    check(bk == 8, f"default block size {bk}, expected 8")
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=core.max_seq,
                        core=core, pool="paged", spec_k=SPEC_K,
                        prefill_chunk=bk)
    with counted_steps(core) as calls:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        streams = run_shared(eng, prompts)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        wall = time.perf_counter() - t0
    life = eng.lifetime()
    lanes = calls["fused"] + calls["lanes"]
    print(f"  paged + spec_k={SPEC_K}, bk {bk}, prefill_chunk "
          f"{eng.prefill_chunk}: "
          f"{life['total_tokens']} tokens in {wall:.2f} s "
          f"({life['total_tokens'] / wall:.1f} tok/s, host clock), "
          f"{life['total_ticks']} ticks = {calls['fused']} fused + "
          f"{calls['verify']} verify ({calls['lanes']} lanes)")
    print(f"    prefix_hits={life['prefix_hits']} prefix_admits="
          f"{life['prefix_admits']} tokens_shared={life['tokens_shared']} "
          f"prefill_tokens={life['prefill_tokens']} prompt_tokens="
          f"{life['prompt_tokens']} spec_proposed={life['spec_proposed']} "
          f"spec_accepted={life['spec_accepted']} logits_pulls="
          f"{life['logits_pulls']}")
    check(life["total_completed"] == SLOTS,
          f"{life['total_completed']}/{SLOTS} requests finished")
    check(life["prefix_hits"] > 0, "no admission hit the prefix registry")
    check(life["spec_proposed"] > 0, "no draft was proposed")
    check(calls["verify"] > 0, "no verify window ran")
    check(life["spec_accepted"] > 0 or not hold_accepted,
          "no draft token was accepted")
    check(life["logits_pulls"] == 0,
          f"greedy serving pulled logits {life['logits_pulls']} times")
    prefilled = life["prefix_admits"] - life["prefix_hits"]
    check_launches(counts, decoder_launches(core.cfg.n_layers)(
        0, prefilled, lanes=lanes, fused=calls["fused"]), "paged")
    # K3 samples the fused ticks only (verify lanes take the argmax of
    # their logits, as the reference's verify step does): when drafts are
    # accepted all the way (olmoe-1b-7b), every tick may be a verify tick
    path = ("flash_attention", "decode_attention_paged_write") + (
        ("fused_sample",) if calls["fused"] else ())
    check(all(counts[k] > 0 for k in path),
          f"the paged path skipped a kernel: {counts}")
    return counts, streams


# --------------------------------------------------------------------- phase 4


def dense_shared(core, prompts):
    """The dense plain engine on the paged run's prompts and schedule.
    prefill_chunk equals the block size on both sides: a shared prefix was
    computed by another request's ticks, an unshared one by the request's
    own, and they agree bit for bit only when both come from the same
    operations at the same shapes.  Every op of the tick works row by row
    at a fixed (8, 1) batch (MoE's expert slabs too: C = N there), and a
    one-shot prefill of one block runs at the same M on both sides; an
    unchunked 200-token prefill would run the projections at M = 200 on
    one side and M = 8 on the other.  (A VLM raises both to its patches +
    1: the one-shot part is the shared patch prefix on both sides.)"""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=core.max_seq,
                        core=core, prefill_chunk=8)
    return run_shared(eng, prompts)


def first_difference(torch, core, prompts, got, want):
    """Where two greedy stream sets first part: the request, the step, the
    two tokens and the logit margin (top 1 less top 2) at that step on
    ``want``'s side, from a one-shot forward over the prompt and ``want``'s
    tokens before the step; None where they agree."""
    import numpy as np
    for rid in sorted(want):
        for step, (a, b) in enumerate(zip(got[rid], want[rid])):
            if a != b:
                toks = np.concatenate([prompts[rid], want[rid][:step]])
                with torch.no_grad():
                    logits, _ = core.params(model_inputs(torch, core, toks))
                top = logits[0, -1].float().topk(2).values
                return (f"request {rid}, step {step}: {a} vs {b}, logit "
                        f"margin there {(top[0] - top[1]).item():.4g}")
    return None


def model_inputs(torch, core, toks):
    """One prompt as the model's inputs, a VLM's zero patches with it (as
    the engine feeds them)."""
    cfg = core.cfg
    inputs = {"tokens": torch.tensor(toks[None], dtype=torch.int32,
                                     device=core.device)}
    if cfg.family == "vlm":
        inputs["patches"] = torch.zeros(1, cfg.n_vision_patches, cfg.d_model,
                                        dtype=cfg.cdtype, device=core.device)
    return inputs


def full_width_streams_phase(torch, core, prompts, paged_streams):
    """The paged + speculative streams equal the dense plain ones."""
    dense = dense_shared(core, prompts)
    check(dense == paged_streams,
          f"paged + spec streams differ from the dense plain ones at "
          f"{first_difference(torch, core, prompts, paged_streams, dense)}: "
          f"{paged_streams} != {dense}")
    print(f"  {len(dense)} full-width greedy streams equal (paged + "
          f"spec_k={SPEC_K} vs dense plain), e.g. rid 0: {dense[0]}")


def run_all(eng, requests):
    """Submit every request at once, step to the end and return the greedy
    streams by request id."""
    for r in requests:
        eng.submit(r, now=0.0)
    done, step = [], 0
    while len(done) < len(requests):
        step += 1
        check(step < 5000, "the run did not finish")
        done.extend(eng.step(now=float(step)))
    return {r.rid: list(r.tokens_out) for r in done}


def random_requests(vocab):
    """8 requests of 200 random prompt tokens and 16 generated, seeded."""
    import numpy as np
    from repro_torch.serving import synthetic_requests
    from repro_torch.sim.serving import WorkloadSpec
    return synthetic_requests(WorkloadSpec(prompt_len=200, gen_len=GEN_LEN),
                              SLOTS, vocab, rng=np.random.default_rng(2))


def recurrent_paged_phase(torch, ops, core, label, expected):
    """ServingEngine(pool="paged", spec_k=3) at full width on a model with
    recurrent state: nothing is shared or speculated.  zamba2-2.7b pages
    its shared blocks' K/V (K5's write instance carries every tick, K1's
    none) and keeps the Mamba2 state dense; falcon-mamba-7b has nothing to
    page, and "paged" is the dense pool.  Launch counts must equal
    ``expected(fused ticks, admissions)``."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=MAX_SEQ, core=core,
                        pool="paged", spec_k=SPEC_K)
    pages = core.cfg.hybrid is not None
    check(eng._paged == pages and not getattr(eng.pool, "can_share", False),
          f"{label}'s paged pool must {'' if pages else 'not '}page the "
          f"attention K/V and share nothing")
    with counted_steps(core) as calls:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        streams = run_all(eng, random_requests(core.cfg.vocab))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        wall = time.perf_counter() - t0
    life = eng.lifetime()
    admitted, hits = eng.stats.total_admitted, life.get("prefix_hits", 0)
    print(f"  {label} paged + spec_k={SPEC_K}: {life['total_tokens']} tokens "
          f"in {wall:.2f} s ({life['total_tokens'] / wall:.1f} tok/s, host "
          f"clock), {calls['fused']} fused + {calls['verify']} verify ticks, "
          f"admissions {admitted}, prefix_hits={hits} spec_proposed="
          f"{life['spec_proposed']} logits_pulls={life['logits_pulls']}")
    check(life["total_completed"] == SLOTS,
          f"{life['total_completed']}/{SLOTS} requests finished")
    check(life["spec_proposed"] == 0 and calls["verify"] == 0,
          f"{label} speculated: recurrent state cannot rewind")
    check(hits == 0, f"{label} shared a prefix")
    check(life["logits_pulls"] == 0,
          f"greedy serving pulled logits {life['logits_pulls']} times")
    check_launches(counts, expected(calls["fused"], admitted),
                   f"{label} paged")
    return counts, streams


def recurrent_streams_phase(core, label, paged_streams):
    """The dense plain engine on the same requests: the same greedy
    streams, request for request (K5 reads the blocks in K1's order, its
    write instance writes what K1's writes, the recurrent state is the
    same)."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=MAX_SEQ, core=core)
    dense = run_all(eng, random_requests(core.cfg.vocab))
    check(dense == paged_streams,
          f"{label} paged streams {paged_streams} != dense {dense}")
    print(f"  {len(dense)} full-width {label} greedy streams equal (paged + "
          f"spec_k={SPEC_K} vs dense), e.g. rid 0: {dense[0]}")


def drop_fracs(torch, core, prompts):
    """drop_frac of a one-shot forward over each prompt, averaged over the
    MoE layers (the forward's aux sums them)."""
    out = []
    for p in prompts:
        with torch.no_grad():
            _, aux = core.params({"tokens": torch.tensor(
                p[None], dtype=torch.int32, device=core.device)})
        out.append(aux["drop_frac"].item() / core.cfg.n_layers)
    return out


SMOKE_PATHS = {
    "qwen2.5-3b": (
        ("dense", {}, ("decode_attention_write", "fused_sample",
                       "flash_attention")),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("decode_attention_paged_write", "flash_attention"))),
    "zamba2-2.7b": (
        ("dense", {}, ("ssm_scan", "flash_attention",
                       "decode_attention_write", "fused_sample")),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("ssm_scan", "flash_attention", "decode_attention_paged_write",
          "fused_sample"))),
    "olmoe-1b-7b": (
        ("dense", {}, ("decode_attention_write", "fused_sample",
                       "flash_attention")),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("decode_attention_paged_write", "flash_attention"))),
    "falcon-mamba-7b": (
        ("dense", {}, ("fused_sample",)),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("fused_sample",))),
    "qwen2-vl-7b": (
        ("dense", {}, ("decode_attention_write", "fused_sample",
                       "flash_attention")),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("decode_attention_paged_write", "flash_attention"))),
    # an encoder-decoder serves plain with spec_k > 0: every tick is fused
    "seamless-m4t-medium": (
        ("dense", {}, ("decode_attention_write", "fused_sample",
                       "flash_attention")),
        ("paged + spec", dict(pool="paged", spec_k=SPEC_K),
         ("decode_attention_paged_write", "fused_sample",
          "flash_attention"))),
}


def streams_phase(torch, ops, arch):
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.engine import EngineCore

    cfg = get_smoke_config(arch)
    max_seq = 48
    gpu = EngineCore(cfg, max_seq, seed=0, device="cuda")
    cpu = EngineCore(cfg, max_seq, params=copy.deepcopy(gpu.params).to("cpu"),
                     device="cpu")

    def run(core, **kw):
        eng = ServingEngine(cfg, slots=3, max_seq=max_seq, prefill_chunk=6,
                            core=core, **kw)
        rng, frng = np.random.default_rng(0), np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, size=10 + i)
                        .astype(np.int32), gen_len=12,
                        frames=frng.standard_normal((5 + 3 * i, cfg.d_model))
                        .astype(np.float32) if cfg.enc_dec else None)
                for i in range(6)]
        done = []
        for step in range(500):
            for r in reqs[2 * step:2 * step + 2]:       # staggered arrivals
                eng.submit(r, now=float(step))
            done.extend(eng.step(now=float(step)))
            if len(done) == len(reqs):
                return {r.rid: r.tokens_out for r in done}
        raise SmokeFailure("smoke-config streams did not finish")

    for name, kw, path in SMOKE_PATHS[arch]:
        ops.reset_launch_counts()
        on_gpu = run(gpu, **kw)
        counts = ops.launch_counts()
        check(all(counts[k] > 0 for k in path),
              f"smoke serving ({name}) skipped a kernel: {counts}")
        check(all(counts[k] == 0 for k in ROW_WRITES_ALONE),
              f"smoke serving ({name}) ran a standalone row write or "
              f"unfused decode: {counts}")
        on_cpu = run(cpu, **kw)
        check(on_gpu == on_cpu,
              f"{arch} {name}: kernel streams {on_gpu} != plain {on_cpu}")
        print(f"  {arch} smoke, {name}: 6 greedy streams equal (kernels vs "
              f"plain), launches {counts}")


# --------------------------------------------------------------------- phase 5


@contextlib.contextmanager
def annotated(torch, label, objs, method="forward"):
    """Each call of ``method`` on these objects inside a
    ``record_function(label)`` range, by a wrapper set on each instance:
    the model's code is unchanged, and the class's method shows again once
    the block ends."""
    def ranged(fn):
        def call(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return call

    for o in objs:
        setattr(o, method, ranged(getattr(o, method)))
    try:
        yield
    finally:
        for o in objs:
            delattr(o, method)


@contextlib.contextmanager
def timed_scan(torch, stats):
    """Mamba1's ``selective_scan`` inside a ``record_function`` range, its
    host time (the Python loop's launches, no synchronize) and calls added
    to ``stats``."""
    from repro_torch.models import mamba
    scan = mamba.selective_scan

    def wrapped(*args):
        t0 = time.perf_counter()
        with torch.profiler.record_function("selective_scan"):
            out = scan(*args)
        stats["host_s"] += time.perf_counter() - t0
        stats["calls"] += 1
        return out

    mamba.selective_scan = wrapped
    try:
        yield stats
    finally:
        mamba.selective_scan = scan


def range_ms(prof, label, n) -> float:
    """Device ms per step of the kernels launched inside ``label``'s
    ranges (the host-side range events, whose device time sums the
    kernels of every op they enclose)."""
    from torch.autograd import DeviceType
    return sum(e.device_time_total for e in prof.key_averages()
               if e.key == label and e.device_type == DeviceType.CPU
               ) / 1e3 / n


def tick_floor(torch, eng):
    """(GB, ms) of what a decode tick reads at least once, over 3.35
    TB/s: every Linear's compute-dtype copy, the MoE expert stacks' copies
    and a tied readout's float32 table; for an encoder-decoder not the
    encoder's weights or the cross K/V projections (they run at admission),
    but the cross K/V rows below each active row's cross_len."""
    from repro_torch.models.moe import MoE
    from repro_torch.nn import Linear
    model = eng.params
    skip = set()
    nbytes = 0
    if model.cfg.enc_dec:
        skip = {id(m) for m in model.enc_blocks.modules()} | {
            id(m) for b in model.dec_blocks
            for m in (b.cross_attn.wk, b.cross_attn.wv)}
        cross = eng.pool.cache["cross"]["k"]
        active = torch.as_tensor(eng.active, device=cross.device)
        rows = int(eng.pool.cache["cross_len"][active].sum())
        nbytes += 2 * cross.shape[0] * rows * cross[0, 0, 0].numel() * \
            cross.element_size()
    for m in model.modules():
        if id(m) in skip:
            continue
        if isinstance(m, Linear):
            nbytes += m.w_c.numel() * m.w_c.element_size()
        elif isinstance(m, MoE):
            nbytes += sum(t.numel() * t.element_size()
                          for t in (m.gate_c, m.up_c, m.down_c))
    if model.lm_head is None:
        nbytes += model.embed.table.numel() * model.embed.table.element_size()
    return nbytes / 1e9, nbytes / PEAK_BYTES_S * 1e3


def range_shares(prof, ranges, n, device_ms):
    return "".join(f"; {label} {range_ms(prof, label, n):.3f} ms of device "
                   f"time ({range_ms(prof, label, n) / device_ms:.1%})"
                   for label in ranges)


def profile_ticks(torch, eng, label, n, n_prof, counted=None,
                  annotate=contextlib.nullcontext, ranges=()):
    """Host time per tick over ``n`` unprofiled ticks, then device time per
    kernel from torch.profiler over ``n_prof`` more, inside ``annotate()``
    with the device time of each of its ``ranges``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step(now=0.0)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / n * 1e3
    before = dict(counted or {})
    with annotate(), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            eng.step(now=0.0)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / n_prof * 1e3
    mix = ""
    if counted is not None:
        mix = (f"; the profiled ticks: {counted['fused'] - before['fused']} "
               f"fused, {counted['verify'] - before['verify']} verify with "
               f"{counted['lanes'] - before['lanes']} lanes")
    device_ms, summed_ms = report_profile(prof, n_prof)
    print(f"  {label} tick: {tick_ms:.2f} ms host clock ({n} ticks, "
          f"unprofiled); profiled {prof_ms:.2f} ms, device busy "
          f"{device_ms:.2f} ms ({device_ms / prof_ms:.0%} of the profiled "
          f"tick; {summed_ms:.2f} ms summed over ops and kernels){mix}"
          f"{range_shares(prof, ranges, n_prof, device_ms)}")
    print_profile(prof, n_prof)


def _by_kernel(prof, n, device_only=False):
    """(name, self device ms per step) of the profiled events, largest
    first; ``device_only``: the device's own events (kernels, copies,
    sets), not the host ops that launched them.  A ``record_function``
    range's device-side event spans the device timeline from its first
    kernel to its last, idle time included: it is no work, and left out
    (``range_ms`` reads a range's kernels)."""
    from torch.autograd import DeviceType
    return sorted(((e.key, e.self_device_time_total / 1e3 / n)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)
                   and (not device_only or e.device_type == DeviceType.CUDA)),
                  key=lambda kv: -kv[1])


def report_profile(prof, n) -> tuple[float, float]:
    """Device busy ms per profiled step: the device's own events summed,
    and the sum over host ops and device events alike that PRs 11-15
    reported (a kernel launched by an aten op counts there twice, under
    the op and under its own name).  Fails if the profiler saw no device
    time."""
    device_ms = sum(t for _, t in _by_kernel(prof, n, device_only=True))
    check(device_ms > 0, "the profiler saw no device time")
    return device_ms, sum(t for _, t in _by_kernel(prof, n))


def print_profile(prof, n, top=12):
    for name, t in _by_kernel(prof, n)[:top]:
        print(f"    {t:8.3f} ms/step  {name[:90]}")


def random_prompts(cfg, n, prompt_len=200, seed=3):
    """n requests of ``prompt_len`` random prompt tokens, seeded."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(3, cfg.vocab, prompt_len)
                    .astype(np.int32), gen_len=GEN_LEN) for i in range(n)]


def profile_admission(torch, core, label="qwen2.5-3b",
                      kernels=(("K4", "flash"),),
                      annotate=contextlib.nullcontext, ranges=(),
                      requests=None):
    """One admission: the unchunked prefill of a prompt (200 random tokens,
    or each of three ``requests``' prompt and frames) into a free slot
    (``ServingEngine.admit``), after one warm-up admission; its host time
    unprofiled, then another's profiled: device time per kernel, each named
    kernel's share (by a pattern of its CUDA names) and each range's beside
    the rest.  Both run inside an ``annotate()`` of their own.  Returns the
    unprofiled host ms."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=core.max_seq,
                        core=core)
    reqs = requests or random_prompts(core.cfg, 3)
    admit = lambda slot, r: eng.admit(slot, r.prompt, GEN_LEN,
                                      frames=r.frames)
    admit(0, reqs[0])
    torch.cuda.synchronize()
    with annotate():
        t0 = time.perf_counter()
        admit(2, reqs[2])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    with annotate(), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        admit(1, reqs[1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, summed_ms = report_profile(prof, 1)
    shares = []
    for name, pattern in kernels:
        k_ms = sum(t for key, t in _by_kernel(prof, 1, device_only=True)
                   if re.search(pattern, key))
        shares.append(f"{name} {k_ms:.3f} ms ({k_ms / device_ms:.1%} of the "
                      f"device time)")
    enc = ("" if reqs[1].frames is None else
           f", {len(reqs[1].frames)} encoder frames")
    print(f"  {label} admission ({len(reqs[1].prompt)}-token prefill{enc}): "
          f"{plain_ms:.2f} ms host "
          f"clock unprofiled, {wall_ms:.2f} ms profiled, device busy "
          f"{device_ms:.2f} ms ({summed_ms:.2f} ms summed over ops and "
          f"kernels)" + "".join("; " + x for x in shares)
          + range_shares(prof, ranges, 1, device_ms))
    print_profile(prof, 1)
    del eng
    free(torch)
    return plain_ms


def profile_dense_tick(torch, core, label, requests=None, **kw):
    """Dense plain: 8 slots, prompts (8 of 200 random tokens, or
    ``requests``) streaming through the tick, as with --prefill-chunk 64;
    the byte floor of a tick beside it."""
    import numpy as np
    from repro_torch.serving import ServingEngine, synthetic_requests
    from repro_torch.sim.serving import WorkloadSpec

    cfg = core.cfg
    eng = ServingEngine(cfg, slots=SLOTS, max_seq=core.max_seq,
                        prefill_chunk=64, core=core)
    if requests is None:
        requests = synthetic_requests(
            WorkloadSpec(prompt_len=200, gen_len=16), 8, cfg.vocab,
            rng=np.random.default_rng(0))
    for r in requests:
        eng.submit(r)
    for _ in range(4):                  # admit every request, warm up
        eng.step(now=0.0)
    gb, floor_ms = tick_floor(torch, eng)
    what = "weights and cross K/V" if cfg.enc_dec else "weights"
    print(f"  {label}: a tick reads at least {gb:.2f} GB of {what}, a byte "
          f"floor of {floor_ms:.3f} ms at 3.35 TB/s")
    profile_ticks(torch, eng, label, n=20, n_prof=10, **kw)


def profile_phase(torch, core, prompts):
    """Where a full-width qwen tick's time goes: the dense plain tick, then
    paged + speculative: the 8 shared-prefix prompts admitted at once,
    prefill chunk one block, so the window holds verify ticks (prompt lanes
    streaming, then drafts)."""
    from repro_torch.serving import Request, ServingEngine

    cfg = core.cfg
    profile_dense_tick(torch, core, "dense plain decode")
    eng = ServingEngine(cfg, slots=SLOTS, max_seq=MAX_SEQ, prefill_chunk=8,
                        core=core, pool="paged", spec_k=SPEC_K)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, gen_len=GEN_LEN))
    for _ in range(4):
        eng.step(now=0.0)
    with counted_steps(core) as calls:
        profile_ticks(torch, eng, f"paged + spec_k={SPEC_K}", n=10,
                      n_prof=5, counted=calls)
    del eng
    free(torch)
    profile_admission(torch, core)


def free(torch):
    """Drop what the last phase left and return the card's cached blocks
    (the next model needs the room)."""
    gc.collect()
    torch.cuda.empty_cache()


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def olmoe_phases(torch, ops, serve, EngineCore, cfg, add):
    """olmoe-1b-7b at full width: the CLI at the published capacity factor
    1.25 (an unchunked 200-token prefill drops tokens); the paged +
    speculative run, the dense plain streams and phase 5 on a dropless
    copy (capacity_factor = E/K: C = N·K, so no expert can overflow and the
    streams cannot depend on which tokens share a batch); then the same
    two runs at 1.25, their streams compared and printed, not held equal,
    beside the drop_frac of one-shot forwards over the prompts."""
    import dataclasses
    print("[3] serve olmoe-1b-7b at full width (capacity factor "
          f"{cfg.moe.capacity_factor})")
    t0 = time.perf_counter()
    add(serve_phase(torch, ops, serve, OSERVE,
                    decoder_launches(cfg.n_layers)))
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=E / K))
    torch.cuda.reset_peak_memory_stats()
    core = EngineCore(dropless, MAX_SEQ, seed=0, device="cuda")
    print(f"  dropless copy, capacity_factor = E/K = {E / K:g}: C = N·K, no "
          f"expert can overflow; the stream equality of phase 4 is held on "
          f"it")
    prompts = shared_prompts(core)
    launches, streams = paged_serve_phase(torch, ops, core, prompts)
    add(launches)
    drops = drop_fracs(torch, core, prompts)
    check(max(drops) == 0.0, f"the dropless copy dropped tokens: {drops}")
    print("[4] greedy streams on the card: olmoe-1b-7b (dropless copy)")
    full_width_streams_phase(torch, core, prompts, streams)
    streams_phase(torch, ops, "olmoe-1b-7b")
    print("[5] where a full-width olmoe-1b-7b tick's and admission's time "
          "goes (dropless copy)")
    moe = [blk.moe for blk in core.params.blocks]
    annotate = lambda: annotated(torch, "moe", moe)
    profile_dense_tick(torch, core, "olmoe dense decode", annotate=annotate,
                       ranges=("moe",))
    profile_admission(torch, core, "olmoe-1b-7b", annotate=annotate,
                      ranges=("moe",))
    print(f"  peak device memory {peak_gib(torch):.2f} GiB")
    del core, moe, annotate
    free(torch)
    print(f"[3] olmoe-1b-7b at capacity factor {cfg.moe.capacity_factor}: "
          f"the paged + speculative run and the dense plain streams")
    core = EngineCore(cfg, MAX_SEQ, seed=0, device="cuda")
    launches, streams = paged_serve_phase(torch, ops, core, prompts)
    add(launches)
    dense = dense_shared(core, prompts)
    where = first_difference(torch, core, prompts, streams, dense)
    drops = drop_fracs(torch, core, prompts)
    print(f"  streams {'equal' if where is None else 'differ: ' + where} "
          f"(not held: with drops a token's experts depend on its batch); "
          f"one-shot forward over each {len(prompts[0])}-token prompt: "
          f"drop_frac per layer {min(drops):.4f} to {max(drops):.4f}")
    del core
    free(torch)
    print(f"  olmoe-1b-7b: {time.perf_counter() - t0:.1f} s")


def falcon_phases(torch, ops, serve, EngineCore, cfg, add):
    """falcon-mamba-7b at full width: the CLI, the paged + speculative
    engine (nothing to page, nothing speculated), its streams against the
    dense engine's, and phase 5 with the selective scan's host time."""
    print("[3] serve falcon-mamba-7b at full width")
    t0 = time.perf_counter()
    add(serve_phase(torch, ops, serve, FSERVE, mamba1_launches))
    torch.cuda.reset_peak_memory_stats()
    core = EngineCore(cfg, MAX_SEQ, seed=0, device="cuda")
    launches, streams = recurrent_paged_phase(torch, ops, core,
                                              "falcon-mamba-7b",
                                              mamba1_launches)
    add(launches)
    print("[4] greedy streams on the card: falcon-mamba-7b")
    recurrent_streams_phase(core, "falcon-mamba-7b", streams)
    streams_phase(torch, ops, "falcon-mamba-7b")
    print("[5] where a full-width falcon-mamba-7b tick's and admission's "
          "time goes")
    profile_dense_tick(torch, core, "falcon dense decode")
    scans = []                  # per admission: the scans' host time

    def annotate():
        scans.append({"host_s": 0.0, "calls": 0})
        return timed_scan(torch, scans[-1])

    plain_ms = profile_admission(torch, core, "falcon-mamba-7b", kernels=(),
                                 annotate=annotate,
                                 ranges=("selective_scan",))
    scan_ms = scans[0]["host_s"] * 1e3
    print(f"  the unprofiled admission's {scans[0]['calls']} selective "
          f"scans: {scan_ms:.2f} ms host clock ({scan_ms / plain_ms:.0%}; "
          f"the loop's launches, 199 a layer, no synchronize)")
    print(f"  peak device memory {peak_gib(torch):.2f} GiB")
    del core
    free(torch)
    print(f"  falcon-mamba-7b: {time.perf_counter() - t0:.1f} s")


def vlm_phases(torch, ops, serve, EngineCore, cfg, add):
    """qwen2-vl-7b at full width: the CLI (1224-token prompts: 1024 patch
    positions and 200 text tokens), the paged + speculative run on the
    shared-prefix prompts behind 1024 shared patch positions, its streams
    against the dense plain engine's, and phase 5.  With random weights
    this model's greedy streams repeat no token (as qwen2.5-3b's and
    olmoe-1b-7b's do), so the prompt-lookup drafts it proposes are not
    accepted: proposed drafts and verify windows are held, accepted ones
    printed."""
    print("[3] serve qwen2-vl-7b at full width")
    t0 = time.perf_counter()
    add(serve_phase(torch, ops, serve, VSERVE,
                    decoder_launches(cfg.n_layers)))
    torch.cuda.reset_peak_memory_stats()
    core = EngineCore(cfg, VL_MAX_SEQ, seed=0, device="cuda")
    prompts = shared_prompts(core)
    launches, streams = paged_serve_phase(torch, ops, core, prompts,
                                          hold_accepted=False)
    add(launches)
    print("[4] greedy streams on the card: qwen2-vl-7b")
    full_width_streams_phase(torch, core, prompts, streams)
    streams_phase(torch, ops, "qwen2-vl-7b")
    print("[5] where a full-width qwen2-vl-7b tick's and admission's time "
          "goes")
    profile_dense_tick(torch, core, "qwen2-vl dense decode",
                       requests=random_prompts(cfg, SLOTS, VL_PROMPT, 0))
    profile_admission(torch, core, "qwen2-vl-7b",
                      requests=random_prompts(cfg, 3, VL_PROMPT))
    print(f"  peak device memory {peak_gib(torch):.2f} GiB")
    del core
    free(torch)
    print(f"  qwen2-vl-7b: {time.perf_counter() - t0:.1f} s")


def encdec_requests(cfg):
    """8 requests of a 200-token decoder prompt and 16 generated, over
    frames of distinct encoder lengths in 128..MAX_SEQ, drawn from
    ENC_SEED."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(ENC_SEED)
    lens = rng.choice(np.arange(128, MAX_SEQ + 1), SLOTS, replace=False)
    return [Request(rid=i, prompt=rng.integers(3, cfg.vocab, 200)
                    .astype(np.int32), gen_len=GEN_LEN,
                    frames=rng.standard_normal((int(n), cfg.d_model))
                    .astype(np.float32)) for i, n in enumerate(lens)]


def encdec_serve_phase(torch, ops, core):
    """ServingEngine at full width on encdec_requests: the dense pool
    unchunked and chunked by 64, and the paged pool with spec_k=3 (it
    serves plain: nothing is speculated or shared).  Every slot holds its
    own encoder length, so cross_len differs across the slots on every
    tick.  Launch counts: 12 K4 per admission (none from the encoder or
    the cross attention, which are plain, as in the reference), 12 K1 (or
    K5) write instances a tick, one K3 a tick.  Returns the launches and
    the streams by run."""
    from repro_torch.serving import ServingEngine
    L = core.cfg.n_layers
    launches, streams = {name: 0 for name in ops.KERNELS}, {}
    lens = sorted(len(r.frames) for r in encdec_requests(core.cfg))
    for label, chunk, kw in (
            ("dense", None, {}), ("dense, prefill chunk 64", 64, {}),
            (f"paged + spec_k={SPEC_K}", None,
             dict(pool="paged", spec_k=SPEC_K))):
        eng = ServingEngine(core.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                            core=core, prefill_chunk=chunk, **kw)
        paged = bool(kw)
        check(eng._paged == paged and not getattr(eng.pool, "can_share",
                                                  False),
              f"seamless {label}: the pool must page the self K/V only "
              f"when asked and share nothing")
        with counted_steps(core) as calls:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            streams[label] = run_all(eng, encdec_requests(core.cfg))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            wall = time.perf_counter() - t0
        life = eng.lifetime()
        admitted, ticks = eng.stats.total_admitted, calls["fused"]
        cross_len = sorted(eng.pool.cache["cross_len"].tolist())
        print(f"  seamless {label}: {life['total_tokens']} tokens in "
              f"{wall:.2f} s ({life['total_tokens'] / wall:.1f} tok/s, host "
              f"clock), {ticks} fused + {calls['verify']} verify ticks, "
              f"admissions {admitted}, cross_len over the slots {cross_len}, "
              f"spec_proposed={life['spec_proposed']} "
              f"logits_pulls={life['logits_pulls']}")
        check(life["total_completed"] == SLOTS,
              f"{life['total_completed']}/{SLOTS} requests finished")
        check(cross_len == lens, f"cross_len {cross_len} != the encoder "
                                 f"lengths {lens}")
        check(life["spec_proposed"] == 0 and calls["verify"] == 0,
              "an encoder-decoder speculated: it serves plain")
        check(life.get("prefix_hits", 0) == 0, "seamless shared a prefix")
        check(life["logits_pulls"] == 0,
              f"greedy serving pulled logits {life['logits_pulls']} times")
        want = (decoder_launches(L)(0, admitted, lanes=ticks, fused=ticks)
                if paged else decoder_launches(L)(ticks, admitted))
        check_launches(counts, want, f"seamless {label}")
        for name in launches:
            launches[name] += counts[name]
        del eng
        free(torch)
    return launches, streams


def encdec_phases(torch, ops, EngineCore, cfg, add):
    """seamless-m4t-medium at full width through ServingEngine (the CLI
    makes no frames, as in the reference), its paged streams against the
    dense ones, and phase 5 with the encoder's and the cross attention's
    device time as ranges."""
    print("[3] serve seamless-m4t-medium at full width (ServingEngine, "
          "frames of encoder lengths 128..1024)")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    core = EngineCore(cfg, MAX_SEQ, seed=0, device="cuda")
    launches, streams = encdec_serve_phase(torch, ops, core)
    add(launches)
    print("[4] greedy streams on the card: seamless-m4t-medium")
    dense, paged = streams["dense"], streams[f"paged + spec_k={SPEC_K}"]
    check(paged == dense, f"seamless paged streams {paged} != dense {dense}")
    chunked = streams["dense, prefill chunk 64"]
    print(f"  {len(dense)} full-width seamless greedy streams equal (paged + "
          f"spec_k={SPEC_K} vs dense), e.g. rid 0: {dense[0]}; chunked by "
          f"64 {'equal' if chunked == dense else 'not equal'} (not held: "
          f"the one-shot part runs at other shapes)")
    streams_phase(torch, ops, "seamless-m4t-medium")
    print("[5] where a full-width seamless-m4t-medium tick's and admission's "
          "time goes")
    model = core.params
    cross = [blk.cross_attn for blk in model.dec_blocks]

    def annotate():
        stack = contextlib.ExitStack()
        stack.enter_context(annotated(torch, "encoder", [model], "_encode"))
        stack.enter_context(annotated(torch, "cross_attn", cross))
        stack.enter_context(annotated(torch, "cross_attn", cross,
                                      "_decode_cross"))
        return stack

    profile_dense_tick(torch, core, "seamless dense decode",
                       requests=encdec_requests(cfg), annotate=annotate,
                       ranges=("cross_attn",))
    profile_admission(torch, core, "seamless-m4t-medium", annotate=annotate,
                      ranges=("encoder", "cross_attn"),
                      requests=encdec_requests(cfg)[:3])
    print(f"  peak device memory {peak_gib(torch):.2f} GiB")
    del core, model, cross, annotate
    free(torch)
    print(f"  seamless-m4t-medium: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------- phase 6


def loop_shapes_phase(torch, ops, ref):
    """The attention kernels at the shapes the closed loop gives them
    (``LoopConfig()``: 4 slots, max_seq 48, a first chunk of 8 tokens):
    K4 at (1,8,16,128) over 2 KV heads in bf16, held to ATTN_TOL and timed
    beside its plain version and SDPA; the write instances of K1 and K5
    over a max_seq-48 cache, 4 rows, bitwise against K2, K2, K1 (K6, K6,
    K5).  K3 at (4, 151936) runs in ``sample_rows``.  Printed; the kernels
    line keeps its shapes."""
    F = torch.nn.functional
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(29)
    S, H, KV, hd = LOOP_CHUNK, 16, 2, 128
    randn = lambda *shape: torch.randn(*shape, generator=g,
                                       device=dev).to(bf16)
    q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
    kernel = lambda: ops.flash_attention(q, k, v, causal=True)
    plain = lambda: ref.flash_attention_ref(q, k, v, causal=True)
    err = max_err(torch, kernel(), plain(), ATTN_TOL,
                  f"flash_attention [loop, (1,{S},{H},{hd})]")
    library = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    b_ms, b_by = bound((2 * S * H * hd + 2 * S * KV * hd) * 2,
                       4 * (S * (S + 1) // 2) * H * hd, PEAK_BF16_S)
    print(f"  qwen2.5-3b loop flash_attention (1,{S},{H},{hd}) KV {KV}: "
          f"kernel {timed_ms(torch, kernel):.4f} ms, plain "
          f"{timed_ms(torch, plain):.4f} ms, library "
          f"{timed_ms(torch, library):.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}), max|err| {err}")
    for paged in (False, True):
        write_instance_row(torch, ops, ref, g, "qwen2.5-3b loop", H, KV, hd,
                           paged, Smax=LOOP_MAX_SEQ, B=LOOP_SLOTS,
                           indices=LOOP_WRITE_INDICES)


def no_backward_phase(torch, ops):
    """The prefill kernels (K4, K7) fill their outputs through ctypes, which
    autograd cannot see: with grad enabled and an input that requires it
    they raise ``NoBackwardError`` and launch nothing; under
    ``torch.no_grad`` (as serving runs) the same call launches."""
    from repro_torch.kernels._lib import NoBackwardError
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    calls = {
        "flash_attention": (lambda *a: ops.flash_attention(*a, causal=True),
                            [randn(1, 16, 4, 64).bfloat16(),
                             randn(1, 16, 2, 64).bfloat16(),
                             randn(1, 16, 2, 64).bfloat16()]),
        "ssm_scan": (ops.ssm_scan,
                     [randn(1, 64, 4, 64), randn(1, 64, 4).abs(),
                      -randn(4).abs(), randn(1, 64, 4, 64),
                      randn(1, 64, 4, 64)]),
    }
    for name, (call, args) in calls.items():
        args[0].requires_grad_(True)
        before = ops.launch_counts()[name]
        try:
            call(*args)
        except NoBackwardError:
            pass
        else:
            raise SmokeFailure(f"{name}: a grad-requiring input did not raise")
        check(ops.launch_counts()[name] == before,
              f"{name}: launched although it raised")
        with torch.no_grad():
            call(*args)
        check(ops.launch_counts()[name] == before + 1,
              f"{name}: did not launch under torch.no_grad")
    print("  flash_attention and ssm_scan raise NoBackwardError on an input "
          "that requires grad (no launch) and launch under torch.no_grad")


def tick_line(t) -> str:
    """One TickLog as ``examples/serve_autoscale.py`` prints it."""
    util = " ".join(f"r{rid}={u:.2f}" for rid, u in t.replica_util)
    flag = " [ANOMALY]" if t.anomaly else ""
    if t.evicted:
        flag += f" [EVICTED r{','.join(map(str, t.evicted))}]"
    return (f"tick {t.tick:2d}: rps={t.rps_target:4.1f} "
            f"arrivals={t.arrivals:2d} served={t.served:2d} "
            f"p50={t.latency_p50_ms:6.0f}ms p95={t.latency_p95_ms:6.0f}ms "
            f"queue={t.queue_depth:4.1f} slot_util[{util}] "
            f"-> {t.replicas} replicas ({t.reason}){flag}")


def trajectory(logs) -> list[dict]:
    """Every TickLog field but ``learn_loss`` (the DQN's, held apart)."""
    import dataclasses
    return [{k: v for k, v in dataclasses.asdict(t).items()
             if k != "learn_loss"} for t in logs]


@contextlib.contextmanager
def timed_router_steps(torch, steps):
    """The host time of every ``ReplicaRouter.step``, synchronised at its
    end, appended to ``steps``."""
    from repro_torch.serving.router import ReplicaRouter
    step = ReplicaRouter.step

    def timed(self, now=0.0):
        t0 = time.perf_counter()
        out = step(self, now)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        return out

    ReplicaRouter.step = timed
    try:
        yield steps
    finally:
        ReplicaRouter.step = step


def loop_launches(cfg, router, paged):
    """The launch counts a loop run must show, from every engine the router
    built (parked and retired ones too): 36 K4 an admission that ran a
    prefill, 36 K1 write instances a fused dense tick (K5's a fused paged
    tick or verify lane), one K3 a fused tick."""
    engines = [rep.engine for rep in router.all_replicas]
    fused = sum(e.fused_ticks for e in engines)
    lanes = sum(e.verify_lanes for e in engines)
    prefilled = sum(e.stats.total_admitted
                    - e.lifetime().get("prefix_hits", 0) for e in engines)
    launches = decoder_launches(cfg.n_layers)
    if paged:
        want = launches(0, prefilled, lanes=fused + lanes, fused=fused)
    else:
        want = launches(fused, prefilled)
    return want, dict(engines=len(engines), fused=fused, lanes=lanes,
                      prefilled=prefilled)


def loop_run(torch, ops, cfg, lc, label, seed, profiled=None, recorder=None,
             prime=None):
    """``run_closed_loop`` on the card, the launch counts set to 0 just
    before and read just after; every tick printed, the fleet totals, the
    host clock per router step and per control tick (the loop's work
    outside ``router.step``), the peak memory.  ``profiled`` = (first,
    last) tick whose router steps torch.profiler records (device busy);
    those ticks stay out of the host-clock means.  ``recorder`` takes the
    loop's per-tick training records; ``prime(alloc)`` runs before the
    first tick, after the allocator is kept."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.closed_loop import run_closed_loop
    sink, allocs, marks, steps = [], {}, [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def keep(alloc):
        allocs["alloc"] = alloc
        if prime is not None:
            prime(alloc)

    def hook(tick, router, collector):
        # the profiler's start and stop fall in the profiled ticks' spans
        if profiled and tick == profiled[1]:
            torch.cuda.synchronize()
            window["stop"] = (time.perf_counter(), len(steps))
            prof.stop()
        marks.append((time.perf_counter(), len(steps)))
        if profiled and tick == profiled[0] - 1:
            prof.start()
            window["start"] = (time.perf_counter(), len(steps))

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with timed_router_steps(torch, steps):
        router, logs = run_closed_loop(
            cfg, autoscale=True, ticks=LOOP_TICKS, seed=seed, lc=lc,
            sink=sink, chaos_hook=hook, device="cuda", recorder=recorder,
            prime_allocator=keep)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    print(f"  {label}: {len(logs)} ticks of {lc.steps_per_tick} router "
          f"steps, {wall:.1f} s with weight init")
    for t in logs:
        print("    " + tick_line(t))
    m = router.metrics()
    print(f"    fleet totals: {m['completed']} requests, "
          f"{m['completed_tokens']} tokens, p50={m['latency_p50_ms']:.0f}ms "
          f"p95={m['latency_p95_ms']:.0f}ms (virtual clock), slot "
          f"utilization {m['slot_utilization']:.3f}, spec "
          f"{m['spec_accepted']}/{m['spec_proposed']} accepted, prefix hits "
          f"{m['prefix_hits']}")
    check(m["completed"] == len(sink) > 0, f"{label}: {m['completed']} "
          f"completed, {len(sink)} in the sink")
    want, seen = loop_launches(cfg, router, lc.pool == "paged")
    print(f"    engines built {seen['engines']}: {seen['fused']} fused "
          f"ticks, {seen['lanes']} verify lanes, {seen['prefilled']} "
          f"admissions prefilled")
    check_launches(counts, want, f"loop {label}")
    skip = {0} | (set(range(profiled[0], profiled[1] + 1)) if profiled
                  else set())
    step_s, ctrl_s = tick_clocks(t0, marks, steps, skip)
    print(f"    host clock: router step {statistics.mean(step_s) * 1e3:.2f} "
          f"ms mean ({statistics.median(step_s) * 1e3:.2f} median, "
          f"{len(step_s)} steps), control tick outside the router steps "
          f"{statistics.mean(ctrl_s) * 1e3:.2f} ms mean over {len(ctrl_s)} "
          f"ticks; peak device memory {peak_gib(torch):.2f} GiB")
    if profiled:
        (ta, na), (tb, nb) = window["start"], window["stop"]
        # the report reads the trace three times; summing a tick of four
        # replicas' events takes tens of seconds, so sum it once
        averages = prof.key_averages()
        prof.key_averages = lambda: averages
        device_ms, summed_ms = report_profile(prof, nb - na)
        step_ms = (tb - ta) / (nb - na) * 1e3
        print(f"    profiled tick{'s' if profiled[1] > profiled[0] else ''} "
              f"{'-'.join(map(str, sorted(set(profiled))))} "
              f"({nb - na} router steps): {step_ms:.2f} ms host clock a "
              f"router step with its share of the control loop, device "
              f"busy {device_ms:.2f} ms a step ({device_ms / step_ms:.0%}; "
              f"{summed_ms:.2f} ms summed over ops and kernels)")
        print_profile(prof, nb - na, top=8)
    streams = {r.rid: list(r.tokens_out) for r in sink}
    recorded = {k: v[:allocs["alloc"].agent.buffer.n].copy()
                for k, v in allocs["alloc"].agent.buffer.data.items()}
    router.close()
    print(f"    {label}: {time.perf_counter() - t0:.1f} s with the reports")
    return dict(logs=logs, streams=streams, counts=counts,
                recorded=recorded, alloc=allocs["alloc"],
                step_ms=(statistics.mean(step_s) * 1e3,
                         statistics.median(step_s) * 1e3))


def tick_clocks(t0, marks, steps, skip):
    """Host clock per router step and per control tick outside the router
    steps: tick i spans mark i-1 .. mark i (``marks`` = (time, steps so
    far) taken at each tick's hook), its router steps are
    steps[n_{i-1}:n_i], the rest of the tick is the control loop's.  The
    ticks in ``skip`` stay out (tick 0: weight init before it; profiled
    ticks)."""
    prev, step_s, ctrl_s = (t0, 0), [], []
    for tick, (t, n) in enumerate(marks):
        if tick not in skip:
            in_steps = sum(steps[prev[1]:n])
            step_s.extend(steps[prev[1]:n])
            ctrl_s.append(t - prev[0] - in_steps)
        prev = (t, n)
    return step_s, ctrl_s


def dnn_tree(net):
    """The port DNN's parameters as the reference's tree of numpy arrays
    (a digit in a name indexes a list): what the weight bridge reads."""
    tree = {}
    for name, p in net.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().cpu().numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(tree)


def dqn_phase(torch, recorded, seed):
    """The allocator's DQN on the card against the CPU: one set of weights
    bridged into an agent on each; q-values on the loop's recorded states
    within DQN_TOL; both buffers filled with the same DQN_TRANSITIONS
    transitions drawn from ``seed``, then DQN_STEPS ``train_offline``
    steps: losses within DQN_TOL, replay draws equal, parameters within
    DQN_TOL but ``dep1.b`` and ``dep2.b``, which feed a training-mode
    BatchNorm and so have no gradient but rounding noise (AdamW turns that
    into steps of up to 1.2·lr, in a direction each device's rounding
    picks), held to that bound, as the running means that absorb them.
    Times ``q_values`` and one train step on each device."""
    import numpy as np
    from repro_torch.core.allocation.rl import DQNAgent
    from repro_torch.core.dnn.model import DNNConfig, MultiStreamDNN
    cfg = DNNConfig()
    src = MultiStreamDNN(cfg, seed=seed, device="cpu")
    tree = dnn_tree(src)
    state = {bn: {k: v.numpy() for k, v in d.items()}
             for bn, d in src.init_state().items()}
    agents = {dev: DQNAgent(cfg, seed=seed, device=dev)
              for dev in ("cuda", "cpu")}
    for a in agents.values():
        a.load_reference(tree, state)
    n = recorded["deploy"].shape[0]
    check(n > 0, "the loop recorded no allocator state")
    q = {dev: np.stack([a.q_values({k: v[i:i + 1]
                                    for k, v in recorded.items()})
                        for i in range(n)]) for dev, a in agents.items()}
    q_err = float(np.abs(q["cuda"] - q["cpu"]).max())
    check(q_err <= DQN_TOL, f"DQN q-values, card vs CPU: max |err| {q_err}")
    rng = np.random.default_rng(seed)
    shapes = {"resource": (cfg.window, cfg.n_resource_features),
              "perf": (cfg.window, cfg.n_perf_features),
              "deploy": (cfg.n_deploy_features,)}
    draw = lambda: {k: rng.normal(size=(1,) + s).astype(np.float32)
                    for k, s in shapes.items()}
    for _ in range(DQN_TRANSITIONS):
        tr = (draw(), int(rng.integers(7)), float(rng.normal()), draw(),
              bool(rng.random() < 0.1))
        for a in agents.values():
            a.buffer.push(*tr)
    losses = {dev: a.train_offline(DQN_STEPS) for dev, a in agents.items()}
    loss_err = float(np.abs(np.subtract(losses["cuda"], losses["cpu"])).max())
    check(loss_err <= DQN_TOL, f"DQN losses, card vs CPU: max |err| "
                               f"{loss_err}")
    check(agents["cuda"].rng.bit_generator.state
          == agents["cpu"].rng.bit_generator.state,
          "the two agents' replay draws differ")
    drift = 2 * 1.2 * agents["cpu"].cfg.lr * DQN_STEPS
    p_err, zero_err = 0.0, 0.0
    cpu = agents["cpu"].params
    for name, p in agents["cuda"].params.items():
        e = float((p.detach().cpu() - cpu[name].detach()).abs().max())
        if name in ("dep1.b", "dep2.b"):
            zero_err = max(zero_err, e)
        else:
            p_err = max(p_err, e)
    check(p_err <= DQN_TOL, f"DQN params, card vs CPU: max |err| {p_err}")
    check(zero_err <= DQN_TOL + drift, f"DQN pre-BatchNorm biases drifted "
                                       f"{zero_err}, past Adam's bound")
    bn_err = 0.0
    for bn, d in agents["cuda"].bn_state.items():
        for k, v in d.items():
            e = float((v.cpu() - agents["cpu"].bn_state[bn][k]).abs().max())
            check(e <= DQN_TOL + (drift if k == "mean" else 0.0),
                  f"DQN {bn} {k}, card vs CPU: max |err| {e}")
            bn_err = max(bn_err, e)
    state1 = {k: v[:1] for k, v in recorded.items()}
    times = {}
    for dev, a in agents.items():
        t_q = []
        for _ in range(20):
            t0 = time.perf_counter()
            a.q_values(state1)
            t_q.append(time.perf_counter() - t0)
        t_train = []
        for _ in range(5):
            t0 = time.perf_counter()
            a.train_offline(1)
            t_train.append(time.perf_counter() - t0)
        times[dev] = (statistics.median(t_q) * 1e3,
                      statistics.median(t_train) * 1e3)
    print(f"  DQN card vs CPU, one set of bridged weights: q-values on the "
          f"loop's {n} recorded states max |err| {q_err:.3g}; "
          f"{DQN_STEPS} train_offline steps over {DQN_TRANSITIONS} "
          f"transitions: losses max |err| {loss_err:.3g}, params "
          f"{p_err:.3g} (dep1.b, dep2.b {zero_err:.3g}, bound "
          f"{DQN_TOL + drift:.3g}), BatchNorm state {bn_err:.3g}")
    for dev, (t_q, t_train) in times.items():
        print(f"    {dev}: q_values {t_q:.2f} ms, one train step "
              f"{t_train:.2f} ms (host clock, median)")


def loop_phase(torch, ops, seed, add):
    """The paper's closed control loop through the port on the card:
    ``run_closed_loop`` with ``LoopConfig()`` on full-width qwen2.5-3b, as
    ``examples/serve_autoscale.py`` drives the reference's; then with the
    paged pool and speculation (streams equal the dense run's, request for
    request); the card's trajectory against the same loop on the CPU at
    smoke width and qwen's vocabulary; the DQN card against CPU."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.dnn.traces import TraceRecorder
    from repro_torch.serving.closed_loop import LoopConfig, run_closed_loop
    cfg = get_config("qwen2.5-3b")
    lc = LoopConfig()
    card_rec, cpu_rec = TraceRecorder(), TraceRecorder()
    check((lc.slots, lc.max_seq, lc.prefill_chunk)
          == (LOOP_SLOTS, LOOP_MAX_SEQ, LOOP_CHUNK),
          "LoopConfig() is not the shape phase 2 checked")
    print(f"[6] the closed control loop on full-width qwen2.5-3b: "
          f"run_closed_loop({LOOP_TICKS} ticks, seed {seed}, autoscale, "
          f"{lc.slots} slots, max_seq {lc.max_seq}, prefill chunk "
          f"{lc.prefill_chunk}, up to {lc.max_replicas} in-process replicas "
          f"sharing one EngineCore, planner mode)")
    t0 = time.perf_counter()
    dense = loop_run(torch, ops, cfg, lc, "dense pool", seed,
                     profiled=LOOP_PROFILED, recorder=card_rec)
    add(dense["counts"])
    traj = [1] + [t.replicas for t in dense["logs"]]
    check(len(set(traj)) > 1, "the scaler never changed the replica count")
    print(f"  replica trajectory: {traj}")
    free(torch)
    paged = loop_run(torch, ops, cfg,
                     dataclasses.replace(lc, pool="paged", spec_k=SPEC_K),
                     f"paged pool + spec_k={SPEC_K}", seed)
    add(paged["counts"])
    # speculation finishes requests sooner, so the two runs' trajectories
    # may differ: every request the dense run finished must have finished
    # in the paged run too, or still be in flight when it ended (rids run
    # 0.. in arrival order), and a request both finished has one stream
    in_flight = (set(range(sum(t.arrivals for t in paged["logs"])))
                 - set(paged["streams"]))
    lost = sorted(set(dense["streams"]) - set(paged["streams"]) - in_flight)
    check(not lost, f"the paged + speculative loop lost requests {lost} "
                    f"that the dense loop finished")
    both = sorted(set(paged["streams"]) & set(dense["streams"]))
    differ = [rid for rid in both
              if paged["streams"][rid] != dense["streams"][rid]]
    check(not differ, f"the paged + speculative loop's streams differ from "
                      f"the dense loop's for requests {differ}")
    print(f"  paged + speculative streams equal the dense loop's for all "
          f"{len(both)} requests both finished (dense "
          f"{len(dense['streams'])}, paged {len(paged['streams'])}; "
          f"{len(dense['streams']) - len(both)} dense-finished requests "
          f"still in flight when the paged run ended)")
    free(torch)
    smoke = get_smoke_config("qwen2.5-3b", vocab=cfg.vocab)
    t1 = time.perf_counter()
    router, cpu_logs = run_closed_loop(smoke, autoscale=True,
                                       ticks=LOOP_TICKS, seed=seed, lc=lc,
                                       device="cpu", recorder=cpu_rec)
    router.close()
    want, got = trajectory(cpu_logs), trajectory(dense["logs"])
    diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None)
    check(len(got) == len(want) and diff is None,
          f"the card's trajectory differs from the CPU smoke run's at tick "
          f"{diff}: {got[diff] if diff is not None else ''} vs "
          f"{want[diff] if diff is not None else ''}")
    print(f"  the card's {len(got)} TickLogs (every field but learn_loss) "
          f"equal the CPU's at smoke width, vocab {cfg.vocab} "
          f"({time.perf_counter() - t1:.1f} s on the CPU)")
    t1 = time.perf_counter()
    dqn_phase(torch, dense["recorded"], seed)
    print(f"  closed loop: {time.perf_counter() - t0:.1f} s (the DQN check "
          f"{time.perf_counter() - t1:.1f} s)")
    return dict(cfg=cfg, smoke=smoke, lc=lc, planner=dense,
                card_trace=card_rec.records, cpu_trace=cpu_rec.records)


# --------------------------------------------------------------------- phase 7
# the offline learning path on the planner trace phase 6 recorded:
# pretrain_on_trace at the reference's defaults, the hybrid loop it primes,
# permutation importance, the strategy head and a canary rollout
PRETRAIN_TOL, ROLLOUT_TICKS = 1e-4, 20
# the elements whose gradient is rounding noise when every row of a batch
# carries one deployment vector, as a recorded trace does: the deployment
# stream before its last normalisation, bn2's bias behind its ReLU at 0,
# and the trunk's first-layer rows that read that ReLU (the deployment
# features come last, after 2 x 32 conv and 32 GRU features)
NOISE_LEAVES = ("dep1.w", "dep1.b", "bn1.scale", "bn1.bias", "dep2.w",
                "dep2.b", "bn2.scale", "bn2.bias")
NOISE_ROWS = ("trunk.layers.0.w", 96)
# lr x steps summed over pretrain_on_trace's defaults: 20 supervised and 30
# imitation steps at 1e-3, 60 DQN steps at 5e-4
PRETRAIN_LR_STEPS = 20 * 1e-3 + 30 * 1e-3 + 60 * 5e-4


@contextlib.contextmanager
def timed_pretrain(torch, clocks):
    """The host clock of ``pretrain_on_trace``'s three phases (supervised
    ``fit``, DQN replay, Q-head imitation), synchronised at each end, and
    the network's parameters after each (``clocks["after"][phase]``, a
    flat dict of numpy arrays)."""
    from repro_torch.core.allocation.rl import DQNAgent
    from repro_torch.core.dnn import traces
    saved = traces.fit, DQNAgent.train_offline, DQNAgent.imitate

    def timed(name, fn):
        def run(first, *args, **kw):
            t0 = time.perf_counter()
            out = fn(first, *args, **kw)
            torch.cuda.synchronize()
            clocks[name] = time.perf_counter() - t0
            net = getattr(first, "net", first)     # fit takes the network
            clocks.setdefault("after", {})[name] = flat_tree(
                copy.deepcopy(dnn_tree(net)))
            return out
        return run

    traces.fit = timed("supervised", saved[0])
    DQNAgent.train_offline = timed("dqn", saved[1])
    DQNAgent.imitate = timed("imitation", saved[2])
    try:
        yield clocks
    finally:
        traces.fit, DQNAgent.train_offline, DQNAgent.imitate = saved


def pretraining_prime(torch, records, tree, state, deploy_vec, out):
    """``prime_allocator`` of a hybrid run: the allocator takes the
    full-width deployment vector and the one set of DNN weights, then
    ``pretrain_on_trace(alloc, records)`` at the reference's defaults, each
    phase timed; its pretrained state goes into ``out`` (losses, clocks,
    weights and target as numpy trees, BatchNorm state, generator state,
    Q-values on the trace's states), and every decision is logged."""
    import numpy as np
    from repro_torch.core.dnn.traces import pretrain_on_trace, replay_streams
    from test_torch_checks import decision_log

    def prime(alloc):
        alloc.deploy_vec = np.array(deploy_vec, copy=True)
        alloc.agent.load_reference(tree, state)
        with timed_pretrain(torch, {}) as clocks:
            losses = pretrain_on_trace(alloc, records)
        agent = alloc.agent
        snaps = replay_streams(records, alloc.deploy_vec,
                               window=alloc.dnn_cfg.window)
        # copies: on the CPU a parameter's numpy view would follow the
        # live loop's training
        out.update(
            losses=losses, clocks=clocks,
            tree=copy.deepcopy(dnn_tree(agent.net)),
            target=copy.deepcopy(dnn_tree(agent.target)),
            bn={bn: {k: v.cpu().numpy().copy() for k, v in d.items()}
                for bn, d in agent.bn_state.items()},
            rng=agent.rng.bit_generator.state, warmup=agent.cfg.warmup,
            buffer_n=agent.buffer.n, snaps=snaps,
            q=np.stack([agent.q_values(s) for s in snaps]), decisions=[])
        decision_log(alloc, out["decisions"])
    return prime


def flat_tree(tree, prefix=()):
    """A nested dict/list tree → {"a.0.b": array}."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {".".join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(flat_tree(v, prefix + (str(k),)))
    return out


def param_gaps(a, b):
    """Two flat parameter dicts → ({"determined", "noise"}: max |a - b|,
    the determined leaf with the largest gap)."""
    import numpy as np
    gaps, worst = {"determined": 0.0, "noise": 0.0}, ("", 0.0)
    for name, v in a.items():
        d = np.abs(v - b[name])
        noise = np.zeros(d.shape, bool)
        if name in NOISE_LEAVES:
            noise[...] = True
        elif name == NOISE_ROWS[0]:
            noise[NOISE_ROWS[1]:] = True
        if noise.any():
            gaps["noise"] = max(gaps["noise"], float(d[noise].max()))
        if (~noise).any() and float(d[~noise].max()) > worst[1]:
            worst = (name, float(d[~noise].max()))
    gaps["determined"] = worst[1]
    return gaps, worst[0]


def pretrain_agreement(card, cpu, label, exact):
    """Card against CPU after ``pretrain_on_trace``: the schedule equal
    (phase lengths, transitions, replay and shuffle draws, warmup, buffer);
    the first loss (before any step) within PRETRAIN_TOL; the parameters
    after each phase and the target net compared.  ``exact``: every loss,
    parameter, target parameter and BatchNorm statistic within
    PRETRAIN_TOL.  As the path runs: the noise-driven elements within
    AdamW's step bound summed over the phases, the other gaps printed (the
    noise reaches the trunk through bn2's ReLU)."""
    import numpy as np
    phases = ("supervised", "dqn", "imitation")
    for phase in phases:
        check(len(card["losses"][phase]) == len(cpu["losses"][phase]) > 0,
              f"{label}: {phase} took {len(card['losses'][phase])} steps "
              f"on the card, {len(cpu['losses'][phase])} on the CPU")
    check(card["losses"]["transitions"] == cpu["losses"]["transitions"]
          and card["rng"] == cpu["rng"] and card["warmup"] == cpu["warmup"]
          and card["buffer_n"] == cpu["buffer_n"],
          f"{label}: the schedules differ (transitions, draws, warmup)")
    first = abs(card["losses"]["supervised"][0]
                - cpu["losses"]["supervised"][0])
    check(first <= PRETRAIN_TOL, f"{label}: first supervised loss, card vs "
                                 f"CPU, differs by {first}")
    loss_err = {phase: float(np.abs(np.subtract(
        card["losses"][phase], cpu["losses"][phase])).max())
        for phase in phases}
    bound = 2 * 1.2 * PRETRAIN_LR_STEPS
    after = {phase: param_gaps(card["clocks"]["after"][phase],
                               cpu["clocks"]["after"][phase])
             for phase in phases}
    after["target"] = param_gaps(flat_tree(card["target"]),
                                 flat_tree(cpu["target"]))
    noise = max(g["noise"] for g, _ in after.values())
    determined = max(g["determined"] for g, _ in after.values())
    bn_err = max(float(np.abs(card["bn"][bn][k] - cpu["bn"][bn][k]).max())
                 for bn in card["bn"] for k in card["bn"][bn])
    gaps_text = "; ".join(
        f"after {k} {g['determined']:.3g} ({leaf or '-'}), noise-driven "
        f"{g['noise']:.3g}" for k, (g, leaf) in after.items())
    if exact:
        check(max(loss_err.values()) <= PRETRAIN_TOL,
              f"{label}: losses, card vs CPU, max |err| {loss_err}")
        check(max(determined, noise, bn_err) <= PRETRAIN_TOL,
              f"{label}: parameters, card vs CPU: {gaps_text}; BatchNorm "
              f"state {bn_err}")
    check(noise <= PRETRAIN_TOL + bound,
          f"{label}: the noise-driven elements moved apart by {noise}, "
          f"past AdamW's bound {bound}")
    print(f"  {label}: pretrain_on_trace (20 epochs, 60 DQN steps, 30 "
          f"imitation epochs; {card['losses']['transitions']} transitions) "
          f"card vs CPU: loss curves max |err| "
          + ", ".join(f"{k} {v:.3g}" for k, v in loss_err.items())
          + f"; parameters (max |err|, worst leaf) {gaps_text} (bound "
          f"{PRETRAIN_TOL + bound:.3g}); BatchNorm state {bn_err:.3g}; "
          f"first loss {first:.3g}; schedule and draws equal")
    for dev, run in (("card", card), ("CPU", cpu)):
        c, ls = run["clocks"], run["losses"]
        print(f"    {dev}: " + ", ".join(
            f"{k} {c[k] * 1e3:.1f} ms ({len(ls[k])} steps, loss "
            f"{ls[k][0]:.4f} -> {ls[k][-1]:.4f})" for k in phases)
            + " (host clock)")


def hybrid_agreement(card, cpu, card_logs, cpu_logs, label, held):
    """The card's hybrid TickLogs against the CPU's: equal up to the first
    tick whose decision margin, on either device, is under MARGIN_FACTOR x
    the largest card/CPU Q gap on the trace's states at the pretrained
    weights; a divergence before it fails.  ``held``: that cutoff must
    come after tick 0 (else the rule holds nothing), and learn_loss must
    stay within PRETRAIN_TOL of its size (at least 1) while the
    trajectories are equal: the live TD losses after pretraining reach
    tens, and evaluation-mode BatchNorm amplifies rounding there
    (``test_torch_orchestration`` holds the reference against the port at
    one set of pretrained weights to the same rule).  Not ``held``, the
    comparison is only printed."""
    import numpy as np
    from test_torch_checks import MARGIN_FACTOR, decision_margin
    gap = float(np.abs(card["q"] - cpu["q"]).max())
    margins = [(decision_margin(*a), decision_margin(*b))
               for a, b in zip(card["decisions"], cpu["decisions"])]
    check(len(margins) == len(card_logs) == len(cpu_logs),
          f"{label}: {len(margins)} decisions logged for "
          f"{len(card_logs)} ticks")
    cutoff = next((i for i, m in enumerate(margins)
                   if min(m) < MARGIN_FACTOR * gap), len(margins))
    got, want = trajectory(card_logs), trajectory(cpu_logs)
    diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None)
    at = (f"tick {cutoff} (margins card {margins[cutoff][0]:.3g}, CPU "
          f"{margins[cutoff][1]:.3g})" if cutoff < len(margins)
          else "no tick")
    if held:
        check(cutoff > 0, f"{label}: the margin rule holds no tick: the "
                          f"card/CPU Q gap {gap} puts its cutoff at {at}")
    if diff is not None and diff < cutoff:
        raise SmokeFailure(f"{label}: the card's TickLogs differ from the "
                           f"CPU's at tick {diff}, before the margin cutoff "
                           f"at {at}: {got[diff]} vs {want[diff]}")
    equal = len(got) if diff is None else diff
    loss_err, loss_rel, loss_max = 0.0, 0.0, 0.0
    for a, b in zip(card_logs[:equal], cpu_logs[:equal]):
        check((a.learn_loss is None) == (b.learn_loss is None),
              f"{label}: tick {a.tick} trained on one device only")
        if a.learn_loss is not None:
            err = abs(a.learn_loss - b.learn_loss)
            loss_err = max(loss_err, err)
            loss_rel = max(loss_rel, err / max(1.0, abs(b.learn_loss)))
            loss_max = max(loss_max, abs(b.learn_loss))
    if held:
        check(loss_rel <= PRETRAIN_TOL, f"{label}: learn_loss, card vs CPU, "
                                        f"max |err| {loss_err} (relative "
                                        f"{loss_rel}) at losses up to "
                                        f"{loss_max}")
    n_dqn = [sum(t.reason.startswith("dqn:") for t in logs)
             for logs in (card_logs, cpu_logs)]
    print(f"  {label}{'' if held else ' (printed, not held)'}: Q gap on "
          f"the trace's {len(card['q'])} states {gap:.3g}; the margin falls "
          f"under {MARGIN_FACTOR:g} x the gap at {at}; TickLogs equal "
          + (f"through all {len(got)} ticks" if diff is None
             else f"through tick {diff - 1}, first difference tick {diff}")
          + f"; learn_loss max |err| {loss_err:.3g} (relative "
          f"{loss_rel:.3g}, losses up to {loss_max:.3g}) while equal; Q "
          f"up to {float(np.abs(card['q']).max()):.3g}; DQN decided "
          f"{n_dqn[0]} ticks on the card, {n_dqn[1]} on the CPU")
    return dict(gap=gap, cutoff=cutoff, diff=diff, n_dqn=n_dqn,
                loss_err=loss_err)


def importance_phase(torch, tree, state, records, deploy_vec, lc, seed):
    """``permutation_importance`` on the trace's ``supervised_dataset``
    with the card-pretrained weights, on the card and on the CPU: each
    group's raw increase within PRETRAIN_TOL."""
    from repro_torch.core.dnn import train
    from repro_torch.core.dnn.model import DNNConfig, dnn_from_reference
    from repro_torch.core.dnn.traces import supervised_dataset
    from test_torch_checks import raw_importance
    cfg = DNNConfig()
    ds = supervised_dataset(
        records, deploy_vec, window=cfg.window, slo_ms=lc.slo_ms,
        model_params_b=float(10.0 ** (2.0 * deploy_vec[0])))
    raw, clocks = {}, {}
    for dev in ("cuda", "cpu"):
        net, st = dnn_from_reference(tree, state, cfg, device=dev)
        t0 = time.perf_counter()
        raw[dev] = raw_importance(train._eval_loss, train.FEATURE_GROUPS,
                                  net, st, ds, seed=seed)
        clocks[dev] = time.perf_counter() - t0
    err = max(abs(raw["cuda"][k] - raw["cpu"][k]) for k in raw["cpu"])
    check(err <= PRETRAIN_TOL, f"permutation importance, card vs CPU: max "
                               f"|err| {err}: {raw}")
    total = sum(raw["cuda"].values()) or 1.0
    print(f"  permutation importance ({len(ds['alloc_target'])} rows, "
          f"card-pretrained weights), raw increase of the evaluation loss "
          f"on the card: "
          + ", ".join(f"{k} {v:.4g} ({v / total:.0%})"
                      for k, v in raw["cuda"].items())
          + f"; card vs CPU max |err| {err:.3g}; host clock card "
          f"{clocks['cuda'] * 1e3:.1f} ms, CPU {clocks['cpu'] * 1e3:.1f} ms")


def selector_phase(tree, state, records, snaps, cfg, lc):
    """``DNNSelector`` over the card-pretrained agent, on the card and on
    the CPU (the same weights bridged), over each recorded tick's operating
    point as ``traces._strategy_label`` reads it: the strategy head decides
    from the first context (``min_trained=1``; the default gate, 64, is
    longer than the trace).  Logits within PRETRAIN_TOL of their size (at
    least 1), choices equal: one-deployment training drives the deployment
    stream's running variance toward 0, so evaluation mode multiplies each
    device's rounding of x - running mean by up to 1/sqrt(eps) = 316
    (``test_torch_orchestration`` holds the reference against the port at
    one set of such weights to the same rule).
    → (the card's choice at the last tick, the CPU's)."""
    import numpy as np
    from repro_torch.core.allocation.rl import DQNAgent
    from repro_torch.core.dnn.model import DNNConfig
    from repro_torch.core.orchestration import (
        STRATEGY_NAMES, DeploymentContext, DNNSelector,
    )
    choices, logits, labels = {}, {}, {}
    for dev in ("cuda", "cpu"):
        agent = DQNAgent(DNNConfig(), device=dev)
        agent.load_reference(tree, state)
        sel = DNNSelector(agent, None, min_trained=1)
        choices[dev], logits[dev] = [], []
        for rec, s in zip(records, snaps):
            ctx = DeploymentContext(
                model_params_b=cfg.n_params() / 1e9,
                traffic_rps=float(rec.get("rps", 0.0)), slo_ms=lc.slo_ms,
                error_budget=0.01,
                spare_capacity_frac=max(1.0 - float(rec.get("flop_util",
                                                            0.0)), 0.0),
                cost_sensitivity=0.5, is_critical=True,
                transport_ms=float(rec.get("transport_ms", 0.0)))
            choices[dev].append(sel.select(ctx, s))
            logits[dev].append(sel.strategy_logits(s))
        labels[dev] = [STRATEGY_NAMES[i] for _, i in sel.labels]
    want = np.stack(logits["cpu"])
    diff = np.abs(np.stack(logits["cuda"]) - want)
    err = float(diff.max())
    rel = float((diff / np.maximum(1.0, np.abs(want))).max())
    check(rel <= PRETRAIN_TOL, f"strategy logits, card vs CPU: max |err| "
                               f"{err} (relative {rel})")
    check(choices["cuda"] == choices["cpu"],
          f"strategy choices differ: card {choices['cuda']}, CPU "
          f"{choices['cpu']}")
    print(f"  DNNSelector (card-pretrained head, min_trained=1) over the "
          f"{len(records)} recorded ticks: logits up to "
          f"{float(np.abs(want).max()):.3g}, card vs CPU max |err| "
          f"{err:.3g} (relative {rel:.3g}), choices equal: {choices['cuda']}; "
          f"the tree's: {labels['cuda']}")
    return choices["cuda"][-1], choices["cpu"][-1]


def canary_sample(logs):
    """A CanarySample of a loop run: its ticks' p50 and p95 latencies on
    the virtual clock (ticks that finished requests), every finished
    request, no errors (the in-process replicas drop nothing), and the
    mean slot utilization of its replica reports."""
    import numpy as np
    from repro_torch.core.orchestration import CanarySample
    served = [t for t in logs if t.served]
    utils = [u for t in logs for _, u in t.replica_util]
    return CanarySample(
        latencies_ms=np.asarray([x for t in served
                                 for x in (t.latency_p50_ms,
                                           t.latency_p95_ms)]),
        n_requests=sum(t.served for t in logs), n_errors=0,
        utilization=float(np.mean(utils)) if utils else 0.0)


def host_to_card(torch, nbytes, reps=3):
    """(GB/s, ms) of copying ``nbytes`` from pinned host memory to the
    card, median of ``reps`` copies timed by CUDA events."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        dev.copy_(host, non_blocking=True)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    del host, dev
    ms = statistics.median(times)
    return nbytes / (ms * 1e-3) / 1e9, ms


def rollout_phase(torch, cfg, lc, strategies, hybrid_logs, planner_logs,
                  card):
    """``RolloutManager`` for the chosen strategy: ``DeployEnv`` with
    qwen2.5-3b's bf16 weights, one device a replica, ``lc.max_replicas``
    replicas, ``hbm_fill_gbps`` measured; each soak tick fed the hybrid
    run's sample (canary) against the planner run's (control).  The
    phase sequence and ``elapsed_s`` of the card's choice must equal the
    CPU choice's on the same samples."""
    from repro_torch.core.orchestration import (
        DeployEnv, Phase, RolloutManager, total_deploy_seconds, CATALOG,
    )
    nbytes = cfg.n_params() * 2
    gbps, ms = host_to_card(torch, nbytes)
    print(f"  host -> card copy of qwen2.5-3b's bf16 weights "
          f"({nbytes / 1e9:.3f} GB, pinned): {ms:.2f} ms, {gbps:.2f} GB/s "
          f"({card})")
    env = DeployEnv(params_bytes=nbytes, chips_per_replica=1,
                    n_replicas=lc.max_replicas, hbm_fill_gbps=gbps)
    canary, control = canary_sample(hybrid_logs), canary_sample(planner_logs)
    runs = []
    for strategy in strategies:
        mgr = RolloutManager(strategy, env)
        seq = [(mgr.start().phase.value, mgr.state.traffic_frac,
                mgr.state.elapsed_s)]
        for _ in range(ROLLOUT_TICKS):
            if mgr.state.phase in (Phase.COMPLETED, Phase.ROLLED_BACK):
                break
            s = mgr.tick(canary, control)
            seq.append((s.phase.value, s.traffic_frac, s.elapsed_s))
        runs.append((seq, mgr.state.health_log))
    check(runs[0][0] == runs[1][0], f"rollout differs: card {runs[0][0]}, "
                                    f"CPU {runs[1][0]}")
    seq, health = runs[0]
    check(seq[-1][0] in ("completed", "rolled_back"),
          f"the rollout did not end in {ROLLOUT_TICKS} ticks: {seq}")
    verdicts = [(round(v["latency_p"], 4), v["healthy"]) for v in health]
    print(f"  rollout {strategies[0]} (healthy model time "
          f"{total_deploy_seconds(CATALOG[strategies[0]], env):.1f} s): "
          f"canary p50/p95 mean {canary.latencies_ms.mean():.0f} ms over "
          f"{canary.n_requests} requests, control "
          f"{control.latencies_ms.mean():.0f} ms over {control.n_requests}; "
          f"phases " + " -> ".join(f"{p}@{f:g}" for p, f, _ in seq)
          + f", elapsed_s {seq[-1][2]:.3f}; verdicts (latency p, healthy) "
          f"{verdicts}; equal to the CPU's")


def learning_phase(torch, ops, seed, add, loop):
    """Phase 7: the paper's offline learning and deployment orchestration
    through the port, card against CPU, on the planner trace phase 6
    recorded (see the module docstring)."""
    import dataclasses
    from repro_torch.core.dnn.model import DNNConfig, MultiStreamDNN
    from repro_torch.serving.closed_loop import run_closed_loop
    from test_torch_checks import exact_deploy_stream
    cfg, smoke, lc = loop["cfg"], loop["smoke"], loop["lc"]
    card = gpu_line()
    t0 = time.perf_counter()
    print(f"[7] offline learning and orchestration on the planner trace: "
          f"pretrain_on_trace, the hybrid loop, importance, strategy "
          f"selection and a canary rollout ({card})")
    card_trace, cpu_trace = loop["card_trace"], loop["cpu_trace"]
    first = next((i for i, (a, b) in enumerate(zip(card_trace, cpu_trace))
                  if a != b), None)
    check(len(card_trace) == len(cpu_trace) == LOOP_TICKS and first is None,
          f"the card's planner trace ({len(card_trace)} records) differs "
          f"from the CPU smoke run's at tick {first}")
    print(f"  the card's planner trace equals the CPU smoke run's: "
          f"{len(card_trace)} records of {len(card_trace[0])} fields, every "
          f"field equal (none reads the host clock: the loop runs on its "
          f"virtual clock)")
    src = MultiStreamDNN(DNNConfig(), seed=seed, device="cpu")
    tree = dnn_tree(src)
    state = {bn: {k: v.numpy() for k, v in d.items()}
             for bn, d in src.init_state().items()}
    deploy = loop["planner"]["alloc"].deploy_vec
    hybrid_lc = dataclasses.replace(lc, alloc_mode="hybrid")
    runs = {name: {} for name in ("card", "cpu", "card_exact", "cpu_exact")}
    # the main path: the hybrid loop over full-width replicas, primed by
    # pretrain_on_trace on the card
    hybrid = loop_run(torch, ops, cfg, hybrid_lc, "hybrid, pretrained on "
                      "the planner trace", seed,
                      prime=pretraining_prime(torch, card_trace, tree, state,
                                              deploy, runs["card"]))
    add(hybrid["counts"])
    traj = [1] + [t.replicas for t in hybrid["logs"]]
    print(f"  replica trajectory: {traj} (planner: "
          f"{[1] + [t.replicas for t in loop['planner']['logs']]})")
    free(torch)
    # the pair again with identical rows computed exactly: the same
    # full-width loop on the card, its launches checked but not added
    with exact_deploy_stream():
        exact_run = loop_run(torch, ops, cfg, hybrid_lc, "hybrid, exact "
                             "deployment stream", seed,
                             prime=pretraining_prime(torch, card_trace, tree,
                                                     state, deploy,
                                                     runs["card_exact"]))
    free(torch)
    logs = {"card": hybrid["logs"], "card_exact": exact_run["logs"]}
    t1 = time.perf_counter()
    for name, exact in (("cpu", False), ("cpu_exact", True)):
        with exact_deploy_stream() if exact else contextlib.nullcontext():
            router, logs[name] = run_closed_loop(
                smoke, autoscale=True, ticks=LOOP_TICKS, seed=seed,
                lc=hybrid_lc, device="cpu",
                prime_allocator=pretraining_prime(
                    torch, cpu_trace, tree, state, deploy, runs[name]))
            router.close()
    print(f"  the CPU's hybrid runs, as the path runs and with the exact "
          f"deployment stream, at smoke width (vocab {smoke.vocab}): "
          f"{time.perf_counter() - t1:.1f} s")
    pretrain_agreement(runs["card"], runs["cpu"], "as the path runs", False)
    pretrain_agreement(runs["card_exact"], runs["cpu_exact"],
                       "exact deployment stream", True)
    hybrid_agreement(runs["card"], runs["cpu"], logs["card"], logs["cpu"],
                     "hybrid loop as the path runs, card full width vs CPU "
                     "smoke", False)
    hybrid_agreement(runs["card_exact"], runs["cpu_exact"],
                     logs["card_exact"], logs["cpu_exact"],
                     "hybrid loop, exact deployment stream, card full width "
                     "vs CPU smoke", True)
    importance_phase(torch, runs["card"]["tree"], runs["card"]["bn"],
                     card_trace, deploy, lc, seed)
    choice = selector_phase(runs["card"]["tree"], runs["card"]["bn"],
                            card_trace, runs["card"]["snaps"], cfg, lc)
    rollout_phase(torch, cfg, lc, choice, logs["card"],
                  loop["planner"]["logs"], card)
    print(f"  offline learning and orchestration: "
          f"{time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------- phase 8
# the remote fleet: phase 6's dense loop over worker processes, each serving
# full-width qwen2.5-3b on the card; the memory of the fleet at its peak of
# LoopConfig().max_replicas workers
FLEET_WORKERS = 4              # LoopConfig().max_replicas
FLEET_STDERR_TAIL = 40


def compute_apps() -> list[tuple[int | None, str]]:
    """(pid, used memory) of every process nvidia-smi sees on the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                          "used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    apps = []
    for line in out.stdout.strip().splitlines():
        pid, _, mem = (x.strip() for x in line.partition(","))
        apps.append((int(pid) if pid.isdigit() else None, mem))
    return apps


@contextlib.contextmanager
def worker_processes(out_dir: Path):
    """Track every worker process the port spawns in the block (their
    ``Popen`` handles, in spawn order), send the workers' stderr (and this
    process's) to ``out_dir/stderr.txt``, and have each worker write its
    kernel launch counts and peak device memory into ``out_dir``.  Every
    worker still alive at the end is killed, whatever happened."""
    from repro_torch.serving.worker import STATS_ENV
    spawned = []
    popen = subprocess.Popen

    class Tracked(popen):
        def __init__(self, args, *a, **k):
            super().__init__(args, *a, **k)
            if "repro_torch.serving.worker" in args:
                spawned.append(self)

    out_dir.mkdir(parents=True, exist_ok=True)
    sys.stderr.flush()
    saved = os.dup(2)
    err = open(out_dir / "stderr.txt", "w")
    os.dup2(err.fileno(), 2)
    os.environ[STATS_ENV] = str(out_dir)
    subprocess.Popen = Tracked
    try:
        yield spawned
    finally:
        subprocess.Popen = popen
        del os.environ[STATS_ENV]
        for proc in spawned:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)
        err.close()


def worker_stats(out_dir: Path, pids, timeout_s=60.0):
    """→ (the kernel launch counts the workers ``pids`` wrote when their
    sessions ended, summed; {pid: peak allocated device bytes}); waits for
    each worker's file."""
    deadline = time.monotonic() + timeout_s
    total, peaks = {}, {}
    for pid in pids:
        path = out_dir / f"stats-{pid}.json"
        while not path.exists():
            check(time.monotonic() < deadline,
                  f"worker {pid} wrote no launch counts")
            time.sleep(0.1)
        stats = json.loads(path.read_text())
        for name, n in stats["launches"].items():
            total[name] = total.get(name, 0) + n
        peaks[pid] = stats["device_peak_bytes"]
    return total, peaks


def fleet_memory(torch, spawned, label) -> dict:
    """The fleet at its peak: 4 distinct live worker PIDs, none this
    process's, and nvidia-smi's compute apps — the 4 workers and this
    process, each worker by its PID where nvidia-smi sees this process's
    PID namespace (in a container it may list every process as pid 1 with
    the card's total) — beside the card's used memory from this process's
    view."""
    live = [p.pid for p in spawned if p.poll() is None]
    apps = compute_apps()
    free_b, total_b = torch.cuda.mem_get_info()
    listed = [pid for pid, _ in apps]
    print(f"    {label} at {len(live)} live workers: nvidia-smi compute "
          f"apps (pid, used memory) {apps}; this process pid "
          f"{os.getpid()}; workers {live}; card used "
          f"{(total_b - free_b) / 2**30:.2f} GiB of {total_b / 2**30:.2f}")
    check(len(set(live)) == FLEET_WORKERS and os.getpid() not in live,
          f"{label}: {len(live)} live workers at the peak, expected "
          f"{FLEET_WORKERS} distinct from this process")
    check(len(apps) == FLEET_WORKERS + 1,
          f"{label}: nvidia-smi lists {len(apps)} processes on the card, "
          f"expected the {FLEET_WORKERS} workers and this process")
    if set(live) & set(listed):
        check(set(live) <= set(listed), f"{label}: workers "
              f"{sorted(set(live) - set(listed))} are not on the card")
    else:
        print(f"      nvidia-smi lists PIDs of another namespace "
              f"({sorted(set(listed))}): the workers are told apart by "
              f"count; their peaks follow from their own stats")
    return {"apps": apps, "used_bytes": total_b - free_b}


def fleet_run(torch, ops, cfg, lc, label, seed, spawned, phase6,
              setup_s=0.0):
    """One closed loop over worker processes: run_closed_loop as phase 6
    runs it, the router's steps timed; the TickLogs' decisions and served
    counts and every finished stream held to phase 6's dense in-process
    run, the workers' launch counts summed and held to phase 6's, the
    fleet's memory at its peak read, and no worker left afterwards."""
    from repro_torch.serving.closed_loop import run_closed_loop
    from repro_torch.serving.replica import SocketReplica
    sink, marks, steps, handshakes, peak = [], [], [], [], {}
    rpc = SocketReplica._rpc

    def timed_rpc(self, msg, *, timeout=None):
        t = time.perf_counter()
        out = rpc(self, msg, timeout=timeout)
        if msg["op"] in ("attach", "init"):
            handshakes.append((self.replica_id, msg["op"],
                               time.perf_counter() - t))
        return out

    def hook(tick, router, collector):
        marks.append((time.perf_counter(), len(steps)))
        if not peak and router.replica_count == FLEET_WORKERS:
            peak.update(fleet_memory(torch, spawned, label))

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    SocketReplica._rpc = timed_rpc
    try:
        with timed_router_steps(torch, steps):
            router, logs = run_closed_loop(
                cfg, autoscale=True, ticks=LOOP_TICKS, seed=seed, lc=lc,
                sink=sink, chaos_hook=hook, device="cuda")
    finally:
        SocketReplica._rpc = rpc
    wall = time.perf_counter() - t0
    try:
        for t in logs:
            print("      " + tick_line(t))
        m = router.metrics()
        check(m["completed"] == len(sink) > 0,
              f"{label}: {m['completed']} completed, {len(sink)} in the sink")
        check(peak, f"{label}: the loop never reached {FLEET_WORKERS} "
                    f"replicas")
        want = [(t.replicas, t.reason, t.served) for t in phase6["logs"]]
        got = [(t.replicas, t.reason, t.served) for t in logs]
        diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                    None)
        check(len(got) == len(want) and diff is None,
              f"{label}: tick {diff} (replicas, reason, served) "
              f"{got[diff] if diff is not None else ''} vs phase 6's "
              f"{want[diff] if diff is not None else ''}")
        streams = {r.rid: list(r.tokens_out) for r in sink}
        differ = sorted(rid for rid in set(streams) | set(phase6["streams"])
                        if streams.get(rid) != phase6["streams"].get(rid))
        check(not differ, f"{label}: streams differ from phase 6's for "
                          f"requests {differ[:10]}")
        observed = logs[-1].observed
        if lc.observe_addrs:
            rep0 = next(r for r in router.all_replicas if r.replica_id == 0)
            mine, theirs = rep0.lifetime(), observed[0]["lifetime"]
            for key in ("total_completed", "total_tokens"):
                check(theirs[key] == mine[key],
                      f"{label}: the observer's {key} {theirs[key]} != "
                      f"the router's {mine[key]}")
            print(f"    observer on {observed[0]['addr']}: "
                  f"total_completed {theirs['total_completed']}, "
                  f"total_tokens {theirs['total_tokens']}, equal to "
                  f"replica 0's lifetime() through the router")
        check(m["off_list_spawns"] == 0,
              f"{label}: {m['off_list_spawns']} off-list spawns")
        per_rep = {r.replica_id: r.transport_ms for r in router.all_replicas}
        parent = ops.launch_counts()
    finally:
        router.close()
    step_s, ctrl_s = tick_clocks(
        t0, marks, steps,
        {0} | set(range(LOOP_PROFILED[0], LOOP_PROFILED[1] + 1)))
    print(f"    {label}: {len(logs)} ticks, {wall:.1f} s with worker "
          f"start and init{f' (fleet start {setup_s:.1f} s before)' if setup_s else ''}; "
          f"{m['completed']} requests, {m['completed_tokens']} tokens; "
          f"TickLogs' (replicas, reason, served) and all {len(streams)} "
          f"streams equal phase 6's in-process run")
    print(f"    host clock: router step {statistics.mean(step_s) * 1e3:.2f} "
          f"ms mean ({statistics.median(step_s) * 1e3:.2f} median, "
          f"{len(step_s)} steps; phase 6 in process: "
          f"{phase6['step_ms'][0]:.2f} mean, {phase6['step_ms'][1]:.2f} "
          f"median), control tick outside the router steps "
          f"{statistics.mean(ctrl_s) * 1e3:.2f} ms mean (worker starts "
          f"and inits included)")
    print(f"    transport_ms (EWMA of report/lifetime/resume round trips): "
          f"fleet {m['transport_ms']:.3f} ms; per replica "
          f"{ {rid: round(v, 3) for rid, v in per_rep.items()} }; "
          f"rpc_count {m['rpc_count']}")
    for rid in sorted({r for r, _, _ in handshakes}):
        times = {op: dt for r, op, dt in handshakes if r == rid}
        print(f"    replica {rid}: attach {times.get('attach', 0):.2f} s"
              f"{'' if setup_s else ' (the worker process starting)'}, "
              f"init {times.get('init', 0):.2f} s (the engine built on the "
              f"card)")
    check(not any(parent.values()),
          f"{label}: kernels launched in the router's process: {parent}")


def fleet_phase(torch, ops, seed, loop):
    """Phase 8: phase 6's dense closed loop (planner mode, 14 ticks, 1 → 3
    → 4 → 1) over worker processes on the card, at ``topology="proc"``
    (each replica a ``python -m repro_torch.serving.worker <fd> --device
    cuda`` child) and at ``topology="tcp"`` over ``launch_fleet(4,
    device="cuda")`` with a read-only observer on worker 0.  Each run's
    decisions, served counts and streams equal phase 6's in-process run of
    this chip run; its workers' launch counts, summed, equal phase 6's; 4
    distinct worker PIDs hold memory on the card at the peak; no worker
    survives the run; the workers load the kernel library phase 1 built."""
    import dataclasses
    import tempfile
    from repro_torch.kernels import _lib
    from repro_torch.serving.fleet import launch_fleet
    cfg, lc, phase6 = loop["cfg"], loop["lc"], loop["planner"]
    check(lc.max_replicas == FLEET_WORKERS, "LoopConfig() is not 4 replicas")
    print(f"[8] the remote fleet: phase 6's loop over worker processes, "
          f"full-width qwen2.5-3b each, at topology proc and tcp "
          f"({gpu_line()})")
    libs = sorted((p.name, p.stat().st_mtime_ns)
                  for p in _lib.BUILD_DIR.glob("*.so"))
    check(libs, "phase 1 built no kernel library")
    print(f"  this process before the fleet: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    t0 = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="fleet-", dir=_lib.BUILD_DIR))
    for topology in ("proc", "tcp"):
        run_dir = out_dir / topology
        with worker_processes(run_dir) as spawned:
            try:
                label = f"topology {topology}"
                if topology == "proc":
                    fleet_run(torch, ops, cfg,
                              dataclasses.replace(lc, topology="proc"),
                              label, seed, spawned, phase6)
                    # each worker wrote its counts before answering the
                    # router's shutdown
                    for proc in spawned:
                        proc.wait(timeout=60)
                    counts, peaks = worker_stats(run_dir,
                                                 [p.pid for p in spawned])
                else:
                    t1 = time.perf_counter()
                    fleet = launch_fleet(FLEET_WORKERS, device="cuda")
                    setup = time.perf_counter() - t1
                    try:
                        fleet_run(torch, ops, cfg, dataclasses.replace(
                            lc, topology="tcp", addrs=tuple(fleet.addrs),
                            observe_addrs=(fleet.addrs[0],)), label, seed,
                            spawned, phase6, setup_s=setup)
                        # the sessions ended with the router: each worker
                        # writes its counts before the stand-in scheduler
                        # stops it
                        counts, peaks = worker_stats(
                            run_dir, [p.pid for p in spawned])
                    finally:
                        fleet.close()
                check(counts == phase6["counts"],
                      f"{label}: the workers' launch counts {counts} != "
                      f"phase 6's {phase6['counts']}")
                check(all(peaks.values()),
                      f"{label}: a worker never used the card: {peaks}")
                print(f"    {label}: the workers' launch counts, summed over "
                      f"{len(spawned)} workers, equal phase 6's: "
                      f"{ {k: v for k, v in counts.items() if v} }; each "
                      f"worker's peak device memory (its own "
                      f"max_memory_allocated): "
                      f"{ {pid: round(b / 2**30, 2) for pid, b in peaks.items()} } GiB")
                alive = [p.pid for p in spawned if p.poll() is None]
                check(not alive, f"{label}: workers {alive} outlived the "
                                 f"router")
                # nvidia-smi's list back to this process alone (it may name
                # every process pid 1: count them)
                deadline = time.monotonic() + 30
                while len(apps := compute_apps()) > 1 \
                        and time.monotonic() < deadline:
                    time.sleep(0.5)
                check(len(apps) == 1, f"{label}: nvidia-smi still lists "
                                      f"{apps} after the run")
            except Exception as e:
                codes = [(p.pid, p.poll()) for p in spawned]
                sys.stderr.flush()
                tail = (run_dir / "stderr.txt").read_text().splitlines()
                print(f"  {label} FAILED: {e!r}; workers (pid, exit code): "
                      f"{codes}; stderr tail:")
                for line in tail[-FLEET_STDERR_TAIL:]:
                    print(f"    | {line}")
                if isinstance(e, SmokeFailure):
                    raise
                raise SmokeFailure(f"{label}: {e!r}") from e
        tail = (run_dir / "stderr.txt").read_text().splitlines()
        print(f"    {label}: no worker left ({len(spawned)} spawned; "
              f"nvidia-smi lists this process alone); "
              f"worker stderr {len(tail)} lines"
              + "".join(f"\n    | {line}" for line in tail[-10:]))
    check(libs == sorted((p.name, p.stat().st_mtime_ns)
                         for p in _lib.BUILD_DIR.glob("*.so")),
          "the workers rebuilt the kernel library")
    print(f"  the workers loaded the library phase 1 built ({libs[0][0]}), "
          f"rebuilding nothing; remote fleet: "
          f"{time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------- phase 9

# the tiny families of tests/conftest.py, rebuilt without JAX (float32)
TINY_BASE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                 vocab=64, param_dtype="float32", dtype="float32")
TRAIN_TOL = 1e-4
# full width: qwen2.5-3b, 8 steps of 2 x 256 tokens, at the launcher's
# default lr (printed) and then at 3e-5 (held: the loss falls).  At 3e-4,
# constant and without warmup, the 36-layer model overshoots: its loss
# swings by nats from step to step, in bf16 and in float32 compute alike,
# and need not end below its start (PERF.md §6)
FULL_TRAIN = ["--arch", "qwen2.5-3b", "--steps", "8", "--batch", "2",
              "--seq", "256", "--seed", "0", "--device", "cuda"]
FULL_TRAIN_LRS = (3e-4, 3e-5)
SMOKE_TRAIN = ["--arch", "qwen2.5-3b", "--smoke", "--seq", "32", "--batch",
               "2", "--device", "cuda"]


def tiny_configs():
    from repro_torch.models.config import (
        HybridCfg, ModelConfig, MoECfg, SSMCfg,
    )

    def tiny(family, **kw):
        return ModelConfig(**{"name": f"tiny-{family}", "family": family,
                              **TINY_BASE, **kw})

    return {
        "dense": tiny("dense", qkv_bias=True),
        "swa": tiny("dense", sliding_window=8),
        "vlm": tiny("vlm", m_rope=True, m_rope_sections=(2, 1, 1),
                    n_vision_patches=4),
        "moe": tiny("moe", moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=32,
                                      capacity_factor=4.0)),
        "ssm1": tiny("ssm", n_heads=0, n_kv_heads=0, d_ff=0,
                     ssm=SSMCfg(d_state=4, version=1)),
        "ssm2": tiny("ssm", n_heads=0, n_kv_heads=0, d_ff=0,
                     ssm=SSMCfg(d_state=4, version=2, headdim=8)),
        "hybrid": tiny("hybrid", n_heads=4, n_kv_heads=4, d_ff=64,
                       ssm=SSMCfg(d_state=4, version=2, headdim=8),
                       hybrid=HybridCfg(attn_every=2, n_shared_blocks=2)),
        "audio": tiny("audio", enc_dec=True, n_enc_layers=2),
    }


def train_batches(torch, cfg, n, seq=16, seed=3, device="cpu"):
    """n batches of the counted token pipeline, with the family's extras."""
    from repro_torch.data import DataConfig, TokenPipeline, extra_inputs
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=2, seed=seed))
    return [{k: torch.from_numpy(v).to(device) for k, v in
             extra_inputs(cfg, data.batch(i)).items()} for i in range(n)]


def leaf_gap(torch, got, want) -> float:
    """max |got - want| over max |want| (want all zero: the absolute gap)."""
    top = float(want.abs().max())
    return float((got.cpu() - want).abs().max()) / (top if top > 0 else 1.0)


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def smoke_train_phase(torch, ops):
    """Phase 9.1: each tiny family, one seeded CPU model and its copy on
    the card, the same batches: one step's loss and gradients, 4 AdamW
    steps' losses; then the chunked attention and chunked CE against their
    unchunked forms.  No kernel launches on the train route."""
    from repro_torch.kernels._lib import NoBackwardError
    from repro_torch.models import steps
    from repro_torch.models.attention import Attention
    from repro_torch.models.transformer import LM
    before = ops.launch_counts()
    try:
        for name, cfg in tiny_configs().items():
            cpu = LM(cfg, device="cpu", seed=0)
            card = copy.deepcopy(cpu).to("cuda")
            bs = train_batches(torch, cfg, 4)
            (loss, _), grads = steps.loss_and_grads(cpu, bs[0])
            (gloss, _), ggrads = steps.loss_and_grads(
                card, {k: v.cuda() for k, v in bs[0].items()})
            gaps = {k: leaf_gap(torch, ggrads[k], g) for k, g in grads.items()}
            worst = max(gaps, key=gaps.get)
            step, (opt_init, _) = steps.make_train_step(cfg)
            losses = {}
            for dev, model in (("cpu", cpu), ("cuda", card)):
                state = steps.TrainState(model, opt_init(dict(
                    model.named_parameters())), 0)
                losses[dev] = []
                for b in bs:
                    state, m = step(state, {k: v.to(dev) for k, v in
                                            b.items()})
                    losses[dev].append(float(m["loss"]))
            step_gap = max(rel_gap(a, b) for a, b in
                           zip(losses["cuda"], losses["cpu"]))
            print(f"  {name:6s} loss card {float(gloss):.6f} cpu "
                  f"{float(loss):.6f}; worst gradient leaf {worst} "
                  f"{gaps[worst]:.2e} of its size; 4 AdamW steps' losses "
                  f"within {step_gap:.2e} ({losses['cuda'][-1]:.6f})")
            check(rel_gap(float(gloss), float(loss)) <= TRAIN_TOL,
                  f"{name}: loss card {float(gloss)} vs cpu {float(loss)}")
            check(gaps[worst] <= TRAIN_TOL,
                  f"{name}: gradient {worst} off by {gaps[worst]:.2e}")
            check(step_gap <= TRAIN_TOL,
                  f"{name}: step losses {losses['cuda']} vs {losses['cpu']}")
        # the chunked paths at chunk 16 over 64 tokens, on the card
        g = torch.Generator().manual_seed(5)
        q, k, v = (torch.randn(2, 64, n, 16, generator=g).cuda()
                   .requires_grad_() for n in (4, 2, 2))
        outs = {}
        for chunk in (16, 10**9):
            Attention.CHUNK_Q = chunk
            out = Attention._sdpa_masked(q, k, v, causal=True, window=None)
            outs[chunk] = (out.detach(),) + torch.autograd.grad(
                out.square().sum(), (q, k, v))
        Attention.CHUNK_Q = 1024
        att_gap = max(leaf_gap(torch, a, b.cpu()) for a, b in
                      zip(outs[16], outs[10**9]))
        cfg = tiny_configs()["dense"]
        model = LM(cfg, device="cuda", seed=1)
        b = train_batches(torch, cfg, 1, seq=64, device="cuda")[0]
        params = list(model.parameters())
        for p in params:
            p.requires_grad_()
        h, _ = model(b, train=True, return_hidden=True)
        ce_c = steps.chunked_cross_entropy(model, h, b["labels"], cfg,
                                           chunk=16)
        gc_ = torch.autograd.grad(ce_c, params)
        ce_f = steps.cross_entropy(model(b, train=True)[0], b["labels"])
        gf = torch.autograd.grad(ce_f, params)
        for p in params:
            p.requires_grad_(False)
        ce_gap = max(leaf_gap(torch, a, c.cpu()) for a, c in zip(gc_, gf))
        ce_c, ce_f = float(ce_c.detach()), float(ce_f.detach())
        print(f"  chunked attention (16 of 64 queries) vs unchunked: output "
              f"and gradients within {att_gap:.2e}; chunked CE {ce_c:.7f} "
              f"vs {ce_f:.7f}, gradients within {ce_gap:.2e}")
        check(att_gap <= 1e-5, f"chunked attention off by {att_gap:.2e}")
        check(rel_gap(ce_c, ce_f) <= 1e-6, f"chunked CE {ce_c} vs {ce_f}")
        check(ce_gap <= 1e-5, f"chunked CE gradients off by {ce_gap:.2e}")
    except NoBackwardError as e:
        raise SmokeFailure(f"a kernel ran on the train route: {e}") from e
    finally:
        Attention.CHUNK_Q = 1024
    check(ops.launch_counts() == before,
          f"kernels launched on the train route: {ops.launch_counts()}")


def resume_phase(torch, out_dir: Path):
    """Phase 9.2: the launcher at smoke width on the card, 6 steps with a
    checkpoint every 3, then --resume to 9, against an uninterrupted 9-step
    run: step 9's record and every leaf of step 9's checkpoint."""
    import numpy as np
    from repro_torch.launch import train as train_cli

    def run(tag, argv):
        buf = io.StringIO()
        log = out_dir / f"{tag}.jsonl"
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(SMOKE_TRAIN + argv + ["--log", str(log)])
        check(rc == 0, f"train {tag} exited {rc}")
        return [json.loads(line) for line in log.read_text().splitlines()]

    ck, whole = out_dir / "ck", out_dir / "whole"
    run("first", ["--steps", "6", "--ckpt-dir", str(ck), "--ckpt-every",
                  "3"])
    steps_saved = sorted(int(p.name[5:]) for p in ck.glob("step_*"))
    check(steps_saved == [3, 6], f"checkpoints at {steps_saved}")
    resumed = run("resumed", ["--steps", "9", "--ckpt-dir", str(ck),
                              "--resume"])
    straight = run("straight", ["--steps", "9", "--ckpt-dir", str(whole)])
    a, b = resumed[-1], straight[-1]
    check(a["step"] == b["step"] == 9, f"last records {a} {b}")
    rec_gap = max(rel_gap(a[k], b[k]) for k in a if k not in ("step", "sec"))
    leaves = sorted(p.name for p in (whole / "step_9").glob("*.npy"))
    bitwise, worst = True, 0.0
    for name in leaves:
        x = np.load(ck / "step_9" / name)
        y = np.load(whole / "step_9" / name)
        bitwise &= x.tobytes() == y.tobytes()
        top = float(np.abs(y).max()) or 1.0
        worst = max(worst, float(np.abs(x - y).max()) / top)
    print(f"  resume at smoke width: checkpoints at 3 and 6, resumed to 9: "
          f"step 9's metrics within {rec_gap:.2e} of an uninterrupted run's, "
          f"{len(leaves)} checkpoint leaves within {worst:.2e}; bitwise "
          f"{'equal' if bitwise and rec_gap == 0 else 'not equal'}")
    check(rec_gap <= 1e-6, f"resumed step 9 {a} vs {b}")
    check(worst <= 1e-6, f"resumed checkpoint off by {worst:.2e}")


def full_train_phase(torch, ops, out_dir: Path):
    """Phase 9.3: qwen2.5-3b at full width through the launcher, 8 steps of
    2 x 256 tokens, no kernel launched, every metric finite: first at the
    launcher's default lr 3e-4, printed, then at 3e-5, whose loss must
    fall; the peak memory, the host clock per step and tokens per second
    of each; then one step profiled (forward + backward alone, and the
    whole step)."""
    from repro_torch.launch import train as train_cli
    for lr in FULL_TRAIN_LRS:
        log = out_dir / f"full-{lr}.jsonl"
        args = train_cli.parse_args(FULL_TRAIN + ["--lr", str(lr), "--log",
                                                  str(log)])
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            model = train_cli.train(args).params   # the optimizer state goes
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recs = [json.loads(line) for line in log.read_text().splitlines()]
        n_params = sum(p.numel() for p in model.parameters())
        per_step = recs[-1]["sec"] / (recs[-1]["step"] - recs[0]["step"])
        print(f"  full width qwen2.5-3b, lr {lr}: {model.cfg.n_layers} "
              f"layers, {n_params / 1e9:.3f} B parameters "
              f"({model.embed.table.dtype} masters, {model.cfg.cdtype} "
              f"compute): "
              + "; ".join(f"step {r['step']} loss {r['loss']:.4f} "
                          f"grad_norm {r['grad_norm']:.3f}" for r in recs))
        print(f"    peak {peak_gib(torch):.2f} GiB of "
              f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
              f"; host clock per step after the first {per_step * 1e3:.1f} "
              f"ms, {args.batch * args.seq / per_step:.0f} training tokens/s;"
              f" the launcher {wall:.1f} s with weight init ({gpu_line()})")
        check(recs[0]["step"] == 1 and recs[-1]["step"] == 8,
              f"records at steps {[r['step'] for r in recs]}")
        check(all(math.isfinite(v) for r in recs for v in r.values()),
              f"a metric is not finite: {recs}")
        check(ops.launch_counts() == before,
              f"kernels launched while training: {ops.launch_counts()}")
        if lr != FULL_TRAIN_LRS[-1]:
            del model
    check(recs[-1]["loss"] < recs[0]["loss"],
          f"loss did not fall: {recs[0]['loss']} -> {recs[-1]['loss']}")
    profile_train_step(torch, model, args)
    return model


def profile_train_step(torch, model, args):
    """Device time of one full-width step: ``loss_and_grads`` alone, then
    the whole step (clipping, AdamW leaf by leaf and the recast besides),
    each after a warm call; then the optimizer state is dropped."""
    from repro_torch.models import steps
    from torch.profiler import ProfilerActivity, profile
    step, (opt_init, _) = steps.make_train_step(model.cfg, lr=args.lr)
    state = steps.TrainState(model, opt_init(dict(model.named_parameters())),
                             0)
    b = train_batches(torch, model.cfg, 1, seq=args.seq, seed=args.seed,
                      device="cuda")[0]
    out = {}
    for label in ("forward + backward", "whole step"):
        run = ((lambda: steps.loss_and_grads(model, b))
               if label == "forward + backward" else
               (lambda: step(state, b)))
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        device_ms, _ = report_profile(prof, 1)
        launches = sum(e.count for e in prof.key_averages()
                       if e.key == "cudaLaunchKernel")
        out[label] = device_ms
        print(f"    profiled {label}: device busy {device_ms:.1f} ms, "
              f"{launches} kernel launches")
        print_profile(prof, 1, top=6)
    print(f"    clipping, AdamW and the recast: "
          f"{out['whole step'] - out['forward + backward']:.1f} ms of the "
          f"step's {out['whole step']:.1f} ms of device time")
    # the step's floor: the update reads the gradients for their norm, then
    # reads gradients, masters and both moments and writes the masters and
    # moments, all float32 (8 passes); the products are 6 N tokens bf16 ops
    n = sum(p.numel() for p in model.parameters())
    ms, by = bound(8 * 4 * n, 6 * n * args.batch * args.seq, PEAK_BF16_S)
    print(f"    the step's floor {ms:.2f} ms (by {by}: 8 float32 passes over "
          f"{4 * n / 1e9:.2f} GB; {6 * n * args.batch * args.seq / 1e12:.2f}"
          f" TFLOP at the bf16 rate {PEAK_BF16_S / 1e12:.0f} TFLOP/s would "
          f"take {6 * n * args.batch * args.seq / PEAK_BF16_S * 1e3:.2f} ms)")
    del state


def trained_serve_phase(torch, ops, model):
    """Phase 9.4: with the optimizer state freed, recast and serve 4
    requests of 16 tokens through ServingEngine on the trained weights;
    the streams equal a fresh model's loaded with the same parameters."""
    import numpy as np
    from repro_torch.models.transformer import LM
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.engine import EngineCore
    free(torch)
    model.recast()
    cfg = model.cfg
    g = np.random.default_rng(9)
    prompts = [g.integers(0, cfg.vocab, 64 + 8 * i) for i in range(4)]

    def serve(params, counted):
        core = EngineCore(cfg, 256, params=params, device="cuda")
        eng = ServingEngine(cfg, slots=4, max_seq=256, core=core,
                            device="cuda")
        with counted_steps(core) as calls:
            ops.reset_launch_counts()
            streams = run_all(eng, [Request(rid=i, prompt=p, gen_len=16)
                                    for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        if counted:
            check(len(streams) == 4 and all(len(s) == 16 for s in
                                            streams.values()),
                  f"trained model's requests: {streams}")
            check_launches(counts, decoder_launches(cfg.n_layers)(
                calls["fused"], eng.stats.total_admitted), "trained serve")
        return streams, counts

    streams, counts = serve(model, True)
    fresh = LM(cfg, device="cuda", seed=1)
    with torch.no_grad():
        for p, q in zip(fresh.parameters(), model.parameters()):
            p.copy_(q)
    fresh.recast()
    fresh_streams, _ = serve(fresh, False)
    print(f"  served the trained weights: 4 requests of 16 tokens, streams "
          f"{'equal' if streams == fresh_streams else 'NOT equal'} to a "
          f"fresh model's loaded with them")
    check(streams == fresh_streams, "the trained model's streams differ "
          "from a fresh model loaded with its parameters")
    return counts


def train_phase(torch, ops, add):
    """Phase 9: training on the card (see the module docstring)."""
    import shutil
    import tempfile
    from repro_torch.kernels import _lib
    print(f"[9] train: the train route on the card ({gpu_line()})")
    t0 = time.perf_counter()
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="train-", dir=_lib.BUILD_DIR))
    try:
        smoke_train_phase(torch, ops)
        resume_phase(torch, out_dir)
        model = full_train_phase(torch, ops, out_dir)
        add(trained_serve_phase(torch, ops, model))
        del model
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    free(torch)
    print(f"  phase 9: {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the closed loop's arrivals and of the "
                         "DQN check's transitions and weights")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # the check instrumentation phase 7 shares with the tests (no JAX)
    sys.path.insert(0, str(ROOT / "tests"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _lib, ops, ref
    from repro_torch.kernels.sample import sample_noise
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineCore

    resolve_device("cuda")       # TF32 off, as everywhere in the port
    t_start = time.perf_counter()
    try:
        card = gpu_line()
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
        t0 = time.perf_counter()
        _lib.load()
        print(f"[1] build: {time.perf_counter() - t0:.1f} s "
              f"(nvcc {_lib.build_seconds} s)")
        if _lib.build_log is None:
            print("  (library reused from an earlier build: no ptxas output)")
        for name, regs, st, ld in ptxas_report(_lib.build_log or ""):
            print(f"  ptxas {name}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")
        print("[2] kernels against their plain versions")
        rows = kernel_phase(torch, ops, ref, sample_noise)
        attention_shapes_phase(torch, ops, ref, "zamba2-2.7b", 32, 32, 80,
                               seed=13)
        attention_shapes_phase(torch, ops, ref, "olmoe-1b-7b", 16, 16, 128,
                               seed=17)
        attention_shapes_phase(torch, ops, ref, "qwen2-vl-7b", 28, 4, 128,
                               seed=19, Smax=VL_MAX_SEQ, S=VL_PROMPT)
        attention_shapes_phase(torch, ops, ref, "seamless-m4t-medium", 16,
                               16, 64, seed=23)
        loop_shapes_phase(torch, ops, ref)
        no_backward_phase(torch, ops)
        launches = {name: 0 for name in ops.KERNELS}

        def add(counts):
            for name, n in counts.items():
                launches[name] += n

        print("[3] serve qwen2.5-3b at full width")
        add(serve_phase(torch, ops, serve, SERVE,
                        decoder_launches(N_LAYERS)))
        core = EngineCore(get_config("qwen2.5-3b"), MAX_SEQ, seed=0,
                          device="cuda")
        prompts = shared_prompts(core)
        paged_launches, paged_streams = paged_serve_phase(torch, ops, core,
                                                          prompts)
        add(paged_launches)
        print("[4] greedy streams on the card: qwen2.5-3b")
        full_width_streams_phase(torch, core, prompts, paged_streams)
        streams_phase(torch, ops, "qwen2.5-3b")
        print("[5] where a full-width qwen2.5-3b tick's time goes")
        profile_phase(torch, core, prompts)
        del core
        free(torch)
        print("[3] serve zamba2-2.7b at full width")
        add(serve_phase(torch, ops, serve, ZSERVE, zamba2_launches))
        zcore = EngineCore(get_config("zamba2-2.7b"), MAX_SEQ, seed=0,
                           device="cuda")
        z_launches, z_streams = recurrent_paged_phase(
            torch, ops, zcore, "zamba2-2.7b",
            lambda ticks, prefilled: zamba2_launches(ticks, prefilled,
                                                     paged=True))
        add(z_launches)
        print("[4] greedy streams on the card: zamba2-2.7b")
        recurrent_streams_phase(zcore, "zamba2-2.7b", z_streams)
        streams_phase(torch, ops, "zamba2-2.7b")
        print("[5] where a full-width zamba2-2.7b tick's and admission's "
              "time goes")
        profile_dense_tick(torch, zcore, "zamba2 dense decode")
        profile_admission(torch, zcore, "zamba2-2.7b", ZAMBA2_KERNELS)
        del zcore
        free(torch)
        olmoe_phases(torch, ops, serve, EngineCore,
                     get_config("olmoe-1b-7b"), add)
        falcon_phases(torch, ops, serve, EngineCore,
                      get_config("falcon-mamba-7b"), add)
        vlm_phases(torch, ops, serve, EngineCore, get_config("qwen2-vl-7b"),
                   add)
        encdec_phases(torch, ops, EngineCore,
                      get_config("seamless-m4t-medium"), add)
        loop = loop_phase(torch, ops, args.seed, add)
        learning_phase(torch, ops, args.seed, add, loop)
        free(torch)
        fleet_phase(torch, ops, args.seed, loop)
        del loop
        free(torch)
        train_phase(torch, ops, add)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
