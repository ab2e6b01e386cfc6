#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one H100.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ray_tpu_torch/ops/csrc (timed);
  3. each forward kernel against its plain PyTorch version at the
     Llama-3-8B shapes in bf16: max-abs error against a stated tolerance,
     and times on the card alone and a call at a time back to back (host
     included), both by CUDA events, beside the bound, the plain version and, for
     flash, F.scaled_dot_product_attention as a yardstick (the port never
     calls it), with TFLOP/s at S = 128, 512 and 2048; paged decode at the
     table's B = 8 and the engine's B = 4, with the L2 warm and cold;
  3b. each flash backward kernel (dQ, dK/dV on the KV-head grid, dK/dV per
     query head) the same way at B = 1 and 8, S = 512 and 2048, through the
     wrapper flash_attention_bwd with each grid forced, with the backward
     of F.scaled_dot_product_attention as the yardstick; both dK/dV grids
     timed in turns, and the grid rule held to the faster one (10%) at
     S = 2048;
  4. a small model (2 layers, head dim 128) in float32 with TF32 off:
     prefill and decode logits and greedy tokens of the CUDA engine
     against the same weights run with device="cpu";
  4b. three CompiledTrainStep steps of the same model on the card against
     the CPU (S = 256: the flash forward and backward kernels run): losses,
     step-1 gradients, the card's weights against AdamW replayed on the CPU
     from the card's gradients, and the weights after step 3;
  4c. phases 4 and 4b on the same model with Mixtral-style MoE layers (8
     experts, top-2, capacity factor 1.25): both decode slots live, the
     engine's requests one after the other (an MoE batch's routing depends
     on who shares it), every layer's dispatch tensor equal card against
     CPU, and some assignments dropped for want of capacity;
  4d. ring attention as n = 4 blocks in one process at the 8B attention
     width (B = 1, S = 8192, H = 32, Hkv = 8, D = 128, causal, bf16): the
     per-block flash forward, log-sum-exp merge and flash backward that
     ring_attention_shard runs on the card, against one whole-sequence
     flash call (O, lse, dq, dk, dv), with exact launch counts (n(n+1)/2
     of each kernel) and the ring's device ms beside the whole call's;
  4e. expert parallelism's split as n = 4 blocks in one process at the
     Mixtral-8x7B layer width (M = 4096, F = 14336, 8 experts, top-2,
     capacity factor 1.25, bf16, x [1, 2048, 4096]): the layer routed once
     and its experts run as 4 blocks of 2 (moe.expert_block), as each rank
     of an ep = 4 world runs them, summed, against the whole layer: equal
     dispatch and the output within 2e-2 of the largest, with both device
     times;
  5. Llama-3-8B at full width and depth, random bf16 weights drawn on the
     card from a seed, served by LLMEngine(max_batch=4, max_len=512,
     page_size=16): six concurrent requests, more than the slots, with
     every launch counter reset just before and read just after;
  5b. Mixtral-8x7B at full width, cut to 16 of its 32 layers (23.5 B
     parameters, 47 GB in bf16), served the same way: first one layer's
     moe_ffn in bf16 against float32 (identical dispatch), and a 128-token
     forward with the flash kernel against plain attention (routing flips
     counted layer by layer from the same input), then the six requests and
     a breakdown of a decode step and a prefill that splits out the expert
     products and routing;
  7. Llama-3-8B at full width and depth trained by CompiledTrainStep (full
     remat, loss_chunk 512, AdamW, B = 1, S = 2048) through the device
     mesh: make_mesh() at world size 1 over NCCL, every collective over a
     group of one. Loss and gradient norms with the flash kernels against
     plain attention, then 2 warm-up and 5 measured steps (ms/step,
     tokens/s, MFU, peak memory) and one step at B = 8, S = 512 (the
     KV-head dK/dV grid), with every launch counter reset just before and
     read just after, the same step without a mesh timed in turns with it,
     and a profiler breakdown of one step;
  7b. Mixtral-8x7B at full width, cut to 4 layers (6.07 B parameters),
     trained the same way through the world-size-1 mesh at B = 1,
     S = 2048 (routing over the gathered global token axis, the experts'
     partial outputs summed over ep and tp): step-0 loss flash against
     plain attention, the MoE aux loss, step 0's dispatch equal through
     the mesh and without it, 2 warm-up and 3 measured steps with exact
     launches, the step without a mesh timed in turns with it, and a
     breakdown of one step;
  7c. the GPipe schedule (pipeline_apply) through make_mesh() at world
     size 1 (pp = 1): the 8B's blocks as the stage function, 4 layers at
     full width, B = 4, S = 2048, 4 microbatches, remat on; forward and
     backward against the same 4 layers on the whole batch without the
     pipeline (hidden state within 2e-2 of the largest, gradient norms
     within 5%), exact launches, and both times in turns;
  8. phase 5's Llama-3-8B weights (14.5 GB of bf16) committed with
     Checkpoint.from_pytree under build/smoke_ckpt (its free space checked
     first), served by LLMDeployment(checkpoint_path=) on phase 5's six
     requests with the launch counters reset: greedy tokens identical to
     phase 5's, save and load GB/s; the directory is deleted;
  8b. llama3_8b cut to 2 layers at full width, B = 1, S = 2048, through
     make_mesh() at world size 1: one step, the training state saved
     sharded under the mesh, restored into a fresh CompiledTrainStep, two
     more steps, against three steps straight from the same seed (losses
     and weights identical, else within 1e-6), with the launches of the
     restore and the two steps;
  9. ResNet-18: two float32 steps at B = 8, card against CPU from the same
     weights (TF32 off; logits, batch statistics, loss within 1e-3), then
     resnet18() in bf16 at the CIFAR-10 geometry (B = 128, 32x32x3,
     synthetic data from a seed), 8 Adam(1e-2) steps (the loss falls;
     ms/step, images/s, a profiled step), committed and scored by
     TorchPredictor on the card (equal to the eval logits bitwise);
  10. telemetry on the main paths ([telemetry] lines): the compiles by fn
     of phase 5's and 5b's engines (decode_step 1, prefill one a bucket)
     and of phase 7's and 7b's steps (one a token shape); after each
     step's main path, memory_snapshot() against torch.cuda.memory_stats
     read at the same moment, the card's total and the memory gauges; the
     collective calls and bytes by op of a mesh step beside the NCCL calls
     the profiler counts in it; the spans of phases 8 and 8b (train_step,
     ckpt_save:, ckpt_restore:) and timeline(path) read back as JSON; the
     decode tap's cost (64-step windows of phase 5's step with and without
     it, in turns); prometheus.render() holding every ray_tpu_device_*
     series;
  11. ingest (data.iter_device_batches) at phase 9's geometry: batches
     read back bitwise equal to their seeded numpy source; ResNet-18's
     bf16 step fed by the ingest against pre-staged batches, in turns; the
     host-to-device rate of a 38.5 MB uint8 batch through the ingest,
     pinned and pageable; a profiler trace of ingested steps (each copy
     on the side stream, finished before its step's first kernel);
  12. RLlib's learner layer: (a) the PPO (with and without APPO's ratio
     clip), A2C, PG, IMPALA (one 200-step fragment), DQN (double Q, plain
     and dueling heads), DDPG, TD3 and SAC learners at hidden 64 and
     minibatch 128, three updates on the card against three on the CPU
     from the same weights (float32, TF32 off; stats within 1e-5
     relative + 1e-6, weights and targets within 1e-4); (b) PPO learning
     a numpy CartPole-v1 (CartPole below) with the learner on the card
     fed by two EnvRunners, as tests/test_rllib.py's PPO test (best mean
     reward above 60 and above the first by 30 within 25 iterations),
     then one update_device's ms, an iteration's sampling ms and a
     profiled update_epochs (device ops, idle share); (c) the ms and
     device ops of one DQN, SAC, TD3 and IMPALA update;
  13. RLlib's remaining learners: (a) the R2D2, recurrent PPO, BC
     (discrete and continuous), MARWIL, CQL, CRR (exp and binary
     weights), DT, QMIX, MADDPG, SlateQ and AlphaZero updates at their
     configs' defaults, three on the card against three on the CPU from
     the same weights and batches under 12a's bounds, R2D2's, QMIX's,
     SlateQ's and CRR-binary's discrete choices equal first; (b) BC, DT
     and AlphaZero learning on the card through the ported algorithms on
     in-process numpy data, to the JAX package's own tests' criteria
     (tests/test_rllib.py BC, tests/test_rllib_families3.py DT and
     AlphaZero); (c) the ms and device ops of one update of each;
  14. the port's runtime and trainer: (a) ray_tpu_torch.init(num_cpus=2)
     on the card: a num_gpus=1 task sees the driver's own
     CUDA_VISIBLE_DEVICES entry and its flash forward (B = 1, S = 512,
     bf16, seeded) equals the driver's bitwise with one launch counted in
     the worker; a CPU task sees no card; a second GPU task waits while a
     GPU actor holds the card and runs once it is killed; worker start and
     the median of 100 no-op task round trips and actor calls printed;
     (b) llama3_8b cut to 2 layers (phase 8b's geometry), B = 1, S = 2048,
     4 steps straight in the driver, then TorchTrainer(trainer_loop,
     ScalingConfig(num_workers=1, use_gpu=True), max_failures=1) in a GPU
     worker: checkpoints committed after steps 1 and 3, the first attempt
     dies (os._exit) at step 2, the second resumes from step 1's: the 4
     losses equal the straight run's, the step-3 checkpoint within 1e-6,
     one restart, the worker's flash launches (reported by the loop, since
     they happen in another process) above 0; no worker outlives
     shutdown();
  15. Ray Data on the port's runtime: (a) range(4096, 16 blocks) ->
     map_batches (a sort key and 256 float32 features from each id) ->
     filter -> random_shuffle(seed=0) -> sort -> union with a second
     dataset -> streaming_split(2) read by two threads, in CPU workers of
     init(num_cpus=2): each stage's rows equal the same plan run locally
     (in order where the order is fixed, else as a multiset), with blocks/s
     and MB/s of the remote run beside its local time; (b) llama3_8b at
     full width and depth from seed 0, saved with Checkpoint.from_pytree,
     scores 64 seeded rows of 512 tokens through BatchPredictor(ckpt,
     TorchPredictor, apply_fn=predict_score) in one GPU actor (batch 8):
     each row's mean log-probability of its next tokens and its argmax next
     token equal to the driver's own forward (argmax equal, log-probability
     within 1e-3), in row order, with 256 flash launches and no paged
     launch in the actor, the actor's start, the restore's GB/s, the first
     batch, steady rows/s and tokens/s and a profiled batch's device-busy
     share; (c) phase 14b's 2-layer 8B trained 4 steps by TorchTrainer(
     use_gpu=True, datasets={"train": ds}), the rank reading its rows with
     get_dataset_shard("train").iter_torch_batches(batch_size=1): losses
     identical to phase 14b's straight run in the driver, the worker's
     launches twice phase 14b's (4 steps against 2), its steady step
     against the driver's and the host µs in next();
  16. Serve's control plane on the port's runtime: init(num_cpus=2), then
     serve.run of ServeProbeLLM (LLMDeployment plus a probe of its process)
     as a GPU replica ({"num_gpus": 1, "max_concurrency": 8}) of the full
     8B drawn from seed 0 in its own worker: its weights' digest equal to
     phase 5's, then one warm-up request and phase 5's six requests at once
     through the handle's streaming call, the same six through POST
     /llm/stream on the proxy (SSE read with urllib) and two through
     handle.remote, every output identical to phase 5's greedy tokens and
     the replica's flash and paged launches above 0 (the kernels line's
     serve_deploy path); the replica's start, TTFT, decode tokens/s, the
     gap between SSE tokens and the serve plane's round trip (100 calls to
     a no-op CPU deployment through the handle and through HTTP); the
     replica's worker killed and replaced by the controller's health check
     (phase 5's tokens again, the recovery seconds); serve.shutdown() ends
     the worker, closes the proxy's port and gives the card's memory back
     to within 1 GB;
  17. RLlib's online loops on the port's runtime (init(num_cpus=4)), every
     learner on the card in the driver, every runner a CPU actor that
     imports its env as chip_smoke.<name>: (a) PPOConfig().environment(
     CartPole)...build() with phase 12b's config (two runners of 256
     steps) learns to tests/test_rllib.py's criteria, its sampled actions
     bitwise equal to phase 12b's in-driver runners' in iteration 1 (and
     counted for how long after), each iteration's sampling ms through the
     actors beside 12b's in the driver; (b) LearnerGroup(remote=True,
     ray_remote_args={"num_gpus": 1}) in a GPU worker from (a)'s final
     weights on its last batch: stats equal to a learner in the driver
     (else within 1e-6), the median of 20 updates each way; (c) DD-PPO
     (its two workers' weights in lockstep within 1e-6) and A3C (its
     parameter server on the card) learn the sign task to the JAX tests'
     criteria; (d) A2C, PG, IMPALA, DQN, DDPG, TD3, SAC, R2D2, recurrent
     PPO, QMIX, MADDPG, SlateQ and AlphaZero built at once on their JAX
     tests' envs, one train() each: the JAX loop's result keys, finite,
     updated; build and runner-start seconds and train() ms; (e) no runner
     worker outlives its stop(), none outlives shutdown(), and no kernel
     launches in the phase;
  6. one JSON line listing each kernel, then the result line
     {"ok": true, "device": {...}} as the last line.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ray_tpu_torch.serve.llm import LLMDeployment

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
L2_BYTES = 50 * 2**20           # H100 L2 cache


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card alone, by CUDA events: a
    sleep kernel holds the stream while the host queues all ``reps`` calls,
    so the card runs them back to back. Unlike :func:`cuda_ms` it leaves
    out the host's time between launches, which is what a few-microsecond
    kernel behind a Python wrapper is otherwise timed by."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queue_s = time.perf_counter() - t0  # the host's time to queue them
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4 * queue_s * 2e9))  # twice that at up to 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, flops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


# ------------------------------------------------ telemetry helpers (10)

def counts_by(name: str, tag: str):
    """{tag value: value} of one series of this process's metrics report."""
    from ray_tpu_torch.util import metrics

    series = metrics.get_metrics_report().get(name, {}).get("series", {})
    return {dict(k)[tag]: v for k, v in series.items()}


def compile_counts():
    return (counts_by("ray_tpu_device_jit_compiles_total", "fn"),
            counts_by("ray_tpu_device_jit_compile_seconds_total", "fn"))


def collective_counts():
    return (counts_by("ray_tpu_device_collective_calls_total", "op"),
            counts_by("ray_tpu_device_collective_bytes_total", "op"))


def grown(after, before):
    """What grew between two {key: value} readings."""
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


@contextlib.contextmanager
def traced():
    """An active span for the block; yields its trace id."""
    from ray_tpu_torch.util import timeline

    trace = timeline.new_trace_id()
    prev = timeline.enter_span(trace, timeline.new_span_id())
    try:
        yield trace
    finally:
        timeline.exit_span(prev)


def span_names(trace: str):
    """The names of the spans recorded under ``trace``, in order."""
    from ray_tpu_torch.util import timeline

    return [e["name"] for e in timeline.timeline()
            if e["args"]["trace_id"] == trace]


# trace id -> the span names phase 10 expects under it (phases 8 and 8b).
SPANS = {}


def check_spans(tag: str, want, card: str) -> None:
    """The spans recorded under each trace of ``want`` ({trace: names})
    are exactly those names, in order."""
    got = {trace: span_names(trace) for trace in want}
    log(f"[telemetry] {tag} spans under an active trace: "
        f"{list(got.values())} (want {list(want.values())}); on {card}")
    assert got == want, (got, want)
    SPANS.update(want)


def phase_build():
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    root = _build.CSRC.parents[2]
    srcs = [str(p.relative_to(root)) for p in _build.sources()]
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc build {_build.build_seconds} s) from {srcs}")
    text = _build.build_log_path().read_text()
    for line in text.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry",
                                   "warning")):
            log(f"[build] {line.strip()}")


def phase_kernels():
    """Kernel against plain version at the 8B shapes, bf16. Every case is
    checked first; then all are timed by CUDA events, a call at a time
    back to back (host included) and with the calls queued ahead of the
    card (:func:`device_ms`, the card alone)."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    cases = {}  # name -> (timed calls, report(ev, dms) -> result, reps)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    # flash: causal, B=1, H=32, Hkv=8, D=128; O tolerance one bf16 ulp at
    # |O| < 4 (both sides accumulate in float32 and round once).
    B, H, Hkv, D = 1, 32, 8, 128
    tol_o, tol_lse = 2e-2, 1e-3
    for S in (128, 512, 2048):
        q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        ro, rl = fa.flash_attention_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        err_o = (o.float() - ro.float()).abs().max().item()
        err_l = (lse - rl).abs().max().item()
        assert err_o <= tol_o and err_l <= tol_lse, (S, err_o, err_l)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        runs = {
            "kernel": lambda q=q, k=k, v=v: fa.flash_attention_fwd(
                q, k, v, causal=True),
            "plain": lambda q=q, k=k, v=v: fa.flash_attention_reference(
                q, k, v, causal=True),
            "sdpa": lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)}
        pairs = S * (S + 1) // 2
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * B * H * S
        flops = 4.0 * B * H * D * pairs  # causal pairs, 2 products

        def report(ev, dms, S=S, nbytes=nbytes, flops=flops, err_o=err_o,
                   err_l=err_l):
            b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
            log(f"[kernels] flash_fwd S={S}: max|dO|={err_o:.3e} (tol "
                f"{tol_o}) max|dlse|={err_l:.3e} (tol {tol_lse}); ms on the card alone: "
                f"kernel {dms['kernel']:.4f} "
                f"({flops / dms['kernel'] / 1e9:.1f} TFLOP/s), plain "
                f"{dms['plain']:.4f}, sdpa {dms['sdpa']:.4f} "
                f"({flops / dms['sdpa'] / 1e9:.1f} TFLOP/s; kernel / sdpa "
                f"{dms['kernel'] / dms['sdpa']:.2f}x); ms a call back to back"
                f" (CUDA events, host included): kernel {ev['kernel']:.4f}, "
                f"plain {ev['plain']:.4f}, sdpa {ev['sdpa']:.4f}; bound "
                f"{b_ms:.5f} ms ({b_by})")
            return dict(max_abs_err=err_o, ms=dms["kernel"],
                        plain_ms=dms["plain"], bound_ms=b_ms, bound_by=b_by,
                        library_ms=dms["sdpa"], event_ms=ev["kernel"])

        cases[f"flash_fwd_S{S}"] = (runs, report, {})

    # paged decode, page 16, Pmax 32 (max_len 512), shuffled page tables:
    # the table's B=8 with lengths across page boundaries over a 256-page
    # pool, and the 8B engine's decode step (4 slots, lengths 300/200/130/
    # 100). Warm: the same pool every launch, left in the 50 MB L2 by the
    # last; cold: launches rotate through copies of the pools, enough that
    # the bytes the launches between two uses of one copy read pass the
    # L2, as a decode step finds a layer's pool after 31 other layers.
    page, Pmax = 16, 32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, lens in ((8, [0, 15, 16, 17, 100, 255, 256, 511]),
                    (4, [300, 200, 130, 100])):
        P = B * Pmax
        q = randn(B, H, D)
        kp, vp = randn(Hkv, P, page, D), randn(Hkv, P, page, D)
        perm = torch.randperm(P, generator=gen, device=dev)
        table = perm.reshape(B, Pmax).to(torch.int32).contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = pa.paged_decode_attention(q, kp, vp, table, lengths)
        ref = pa.paged_decode_reference(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol_o, (B, err)
        keys = int((lengths + 1).sum())
        nbytes = 2 * 2 * q.numel() + 2 * 2 * keys * Hkv * D + 4 * (
            table.numel() + B)
        copies = [(kp, vp)] + [(kp.clone(), vp.clone())
                               for _ in range(-(-L2_BYTES // nbytes))]
        turn = iter(range(1 << 30))
        args = (q, table, lengths)

        def cold(copies=copies, turn=turn, args=args):
            kc, vc = copies[next(turn) % len(copies)]
            pa.paged_decode_attention(args[0], kc, vc, *args[1:])

        runs = {
            "kernel": lambda q=q, kp=kp, vp=vp, args=args:
                pa.paged_decode_attention(q, kp, vp, *args[1:]),
            "cold": cold,
            "plain": lambda q=q, kp=kp, vp=vp, args=args:
                pa.paged_decode_reference(q, kp, vp, *args[1:])}

        def report(ev, dms, B=B, lens=lens, keys=keys, nbytes=nbytes,
                   n_copies=len(copies), err=err):
            b_ms, b_by = bound(nbytes, 4.0 * keys * H * D, BF16_FLOPS_PER_S)
            ms, cold_ms = dms["kernel"], dms["cold"]
            log(f"[kernels] paged_decode B={B} (lengths {lens}, "
                f"{pa.paged_splits(B, Hkv, Pmax, page, sms)} splits): "
                f"max|d|={err:.3e} (tol {tol_o}); ms on the card alone: kernel "
                f"{ms:.4f} warm L2 ({nbytes / ms / 1e6:.0f} GB/s), "
                f"{cold_ms:.4f} cold L2 ({nbytes / cold_ms / 1e6:.0f} GB/s; "
                f"{n_copies} pool copies in turn, "
                f"{(n_copies - 1) * nbytes / 1e6:.0f} MB read between two "
                f"uses of one), plain gather {dms['plain']:.4f}; ms a call "
                f"back to back (CUDA events, host included): kernel "
                f"{ev['kernel']:.4f} warm, {ev['cold']:.4f} cold; bound "
                f"{b_ms:.5f} ms ({b_by})")
            return dict(max_abs_err=err, ms=ms, plain_ms=dms["plain"],
                        bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        cold_l2_ms=cold_ms, event_ms=ev["kernel"])

        cases[f"paged_decode_B{B}"] = (runs, report,
                                       {"cold": 4 * len(copies)})

    ev = {c: {n: cuda_ms(fn, reps=reps.get(n, 20)) for n, fn in runs.items()}
          for c, (runs, _, reps) in cases.items()}
    dms = {c: {n: device_ms(fn, reps=reps.get(n, 20))
               for n, fn in runs.items()}
           for c, (runs, _, reps) in cases.items()}
    return {c: report(ev[c], dms[c]) for c, (_, report, _) in cases.items()}


def phase_backward_kernels():
    """The backward kernels at the 8B attention shape (H=32, Hkv=8, D=128,
    causal, bf16) at B = 1 and 8, S = 512 and 2048. Correctness through the
    wrapper, ``flash_attention_bwd``, with each dK/dV grid forced
    (``DKV_GRID``) and a non-contiguous dO: dq, dk and dv each against
    ``flash_attention_bwd_reference``. Times of each kernel alone through
    its launcher, of the wrapper as the main path runs it, and of the dK/dV
    stage on each grid (the per-head grid with its group sum): at S = 2048
    the phase fails if the grid rule picks a grid slower than the other by
    more than 10%."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16
    lib = _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    H, Hkv, D = 32, 8, 128
    # bf16 tolerance: max|d| <= 1e-2 max|ref| for each of dq, dk and dv.
    # The tensor-core kernels round P and dS to bf16 (relative step 2^-8 =
    # 3.9e-3) as product operands, as flash-attention-2 does, and each
    # gradient sums up to S such terms; the plain version keeps them in
    # float32.
    rel_tol = 1e-2
    grids = {"flash_bwd_dkv": "kv_head", "flash_bwd_dkv_per_head": "per_head"}
    results = {}
    failures = []
    for B, S in ((1, 512), (8, 512), (1, 2048), (8, 2048)):
        q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).to(bf16)
                 for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(bf16)
                for _ in range(2))
        # dO as autograd may hand it over: the same values, not contiguous.
        do_t = do.transpose(1, 2).contiguous().transpose(1, 2)
        assert not do_t.is_contiguous()
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                               causal=True)
        ref_max = [w.float().abs().max().item() for w in ref]
        tag = f"B={B} S={S}"

        # Correctness: the wrapper on each grid.
        errs = {}
        for name, grid in grids.items():
            fa.DKV_GRID = grid
            try:
                before = train_launches()
                got = fa.flash_attention_bwd(q, k, v, o, lse, do_t,
                                             causal=True)
                torch.cuda.synchronize()
                ran = {c: n - before[c] for c, n in train_launches().items()}
            finally:
                fa.DKV_GRID = None
            want = {c: int(c in ("flash_bwd_dq", name)) for c in ran}
            assert ran == want, (name, tag, ran, want)
            e = [(g.float() - w.float()).abs().max().item()
                 for g, w in zip(got, ref)]
            log(f"[kernels] flash_attention_bwd {tag}, {name} grid forced: "
                f"max|d| dq {e[0]:.3e}, dk {e[1]:.3e}, dv {e[2]:.3e} (tol "
                f"{rel_tol} x max|ref| {ref_max[0]:.3e}, {ref_max[1]:.3e}, "
                f"{ref_max[2]:.3e}); launches {ran}")
            if not all(x <= rel_tol * m for x, m in zip(e, ref_max)):
                failures.append((name, tag, e, ref_max))
            errs["flash_bwd_dq"] = max(errs.get("flash_bwd_dq", 0.0), e[0])
            errs[name] = max(e[1], e[2])
        del got, ref

        # Times: each kernel alone, the plain backward, SDPA's backward,
        # the wrapper as the main path runs it, and the dK/dV stage on each
        # grid as the wrapper runs it.
        delta = fa.bwd_delta(o, do)
        kw = dict(causal=True, scale=D ** -0.5, q_offset=0, kv_offset=0,
                  stream=_build.current_stream(q))
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=True), reps=3, warmup=1)
        wrapper_ms = cuda_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do_t, causal=True))
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        gout = do.transpose(1, 2).contiguous()
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), gout, retain_graph=True))
        del out, qt, kt, vt, gout
        pairs = S * (S + 1) // 2
        in_bytes = 2 * 2 * (q.numel() + k.numel()) + 2 * 4 * B * H * S
        timed = {
            "flash_bwd_dq": (
                lambda: fa.launch_bwd_dq(lib, q, k, v, do, lse, delta, **kw),
                3, 2 * q.numel()),
            "flash_bwd_dkv": (
                lambda: fa.launch_bwd_dkv(lib, q, k, v, do, lse, delta,
                                          per_head=False, **kw),
                4, 2 * 2 * k.numel()),
            "flash_bwd_dkv_per_head": (
                lambda: fa.launch_bwd_dkv(lib, q, k, v, do, lse, delta,
                                          per_head=True, **kw),
                4, 2 * 4 * B * S * H * D),
        }
        for name, (fn, products, out_bytes) in timed.items():
            ms = cuda_ms(fn)
            flops = products * 2.0 * D * pairs * B * H
            b_ms, b_by = bound(in_bytes + out_bytes, flops, BF16_FLOPS_PER_S)
            log(f"[kernels] {name} {tag}: kernel alone {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), plain backward "
                f"{plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by})")
            results[f"{name}_B{B}_S{S}"] = dict(
                max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

        # The dK/dV stage on each grid, in turns: KV-head, per-head (kernel
        # and group sum), per-head, KV-head.
        def stage(per_head):
            def run():
                dk, dv = fa.launch_bwd_dkv(lib, q, k, v, do, lse, delta,
                                           per_head=per_head, **kw)
                if per_head:
                    fa.group_sum_dkv(dk, dv, k)
            return run

        turns = [cuda_ms(stage(p)) for p in (False, True, True, False)]
        kv_ms, ph_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        picked = fa.dkv_per_head(B, H, Hkv, S, S, D, dtype=bf16, causal=True,
                                 sms=sms)
        est = fa.dkv_grid_estimates(B, H, Hkv, S, S, D, dtype=bf16,
                                    causal=True, sms=sms)
        got_ms = ph_ms if picked else kv_ms
        ok = got_ms <= 1.1 * min(kv_ms, ph_ms)
        log(f"[kernels] dK/dV grid rule {tag}: KV-head stage "
            f"{turns[0]:.4f}/{turns[3]:.4f} ms, per-head stage with its group "
            f"sum {turns[1]:.4f}/{turns[2]:.4f} ms (in turns); estimates "
            f"{est[0] * 1e3:.4f} / {est[1] * 1e3:.4f} ms; the rule picks "
            f"{'per-head' if picked else 'KV-head'}: "
            f"{'within' if ok else 'NOT within'} 10% of the faster grid")
        if S == 2048 and not ok:
            failures.append(("grid rule", tag, kv_ms, ph_ms, picked))
        grid = "per-query-head" if picked else "KV-head"
        log(f"[kernels] flash_attention_bwd {tag} as the main path runs it "
            f"(delta, dQ, dK/dV on the {grid} grid): {wrapper_ms:.4f} ms "
            f"against sdpa backward {lib_ms:.4f} ms "
            f"({wrapper_ms / lib_ms:.2f}x)")
        del q, k, v, do, do_t, o, lse, delta
        torch.cuda.empty_cache()
    assert not failures, failures
    return results


def small_f32_config(n_experts: int = 0):
    """Phases 4, 4b and 4c's model: 2 layers, head dim 128 (both attention
    kernels take it), float32; with ``n_experts`` MoE layers (top-2,
    capacity factor 1.25)."""
    from ray_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=256, hidden_size=512, intermediate_size=1024,
                       num_layers=2, num_heads=4, num_kv_heads=2,
                       rope_theta=10_000.0, dtype=torch.float32,
                       n_experts=n_experts)


@contextlib.contextmanager
def recorded_routing():
    """Yields a list that collects (dispatch, token_mask, k, chosen) of
    every ``top_k_routing`` call inside the block, on any device and
    thread (``moe_ffn`` looks the function up in its module at each call);
    ``chosen`` [T, k] is the router's top-k experts of each token, in
    index order, before capacity drops any."""
    from ray_tpu_torch.parallel import moe

    inner = moe.top_k_routing
    calls = []

    def record(logits, k, capacity, token_mask=None):
        out = inner(logits, k, capacity, token_mask)
        top = logits.sort(dim=-1, descending=True, stable=True).indices
        calls.append((out[0], token_mask, k, top[:, :k].sort(-1).values))
        return out

    moe.top_k_routing = record
    try:
        yield calls
    finally:
        moe.top_k_routing = inner


def dropped(calls) -> int:
    """Assignments that found their expert full, over recorded calls."""
    n = 0
    for dispatch, mask, k, _ in calls:
        rows = dispatch.shape[0] if mask is None else int(mask.sum())
        n += k * rows - int(dispatch.sum())
    return n


def kept_experts(dispatch: torch.Tensor) -> torch.Tensor:
    """[T, E] bool: the experts each token is kept by."""
    return dispatch.sum(dim=-1) > 0


def params_to(params, device):
    return {k: (params_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def cpu_copy(tree):
    """A copy of a tree of tensors on the CPU, sharing nothing with it."""
    return {k: (cpu_copy(v) if isinstance(v, dict)
                else v.detach().to("cpu", copy=True)) for k, v in tree.items()}


def flat_tree(tree):
    """{name: tensor} of a parameter tree, layer leaves as ``layers.<k>``."""
    out = {k: v for k, v in tree.items() if torch.is_tensor(v)}
    out.update({f"layers.{k}": v for k, v in tree["layers"].items()})
    return out


def phase_parity(cfg=None, tag: str = "parity", active=(False, True),
                 concurrent: bool = True):
    """Card against CPU, float32 with TF32 off, on a 2-layer model whose
    head dim (128) both kernels take (default: phase 4's dense one). Slot 1
    holds a 130-token prompt (bucket 256: the flash route) and, where
    ``active[0]``, slot 0 a 20-token one (bucket 32: the plain route); the
    ``active`` slots then decode 8 steps. ``concurrent`` submits the
    engine's two requests at once, else one after the other."""
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.models.generation import (
        PagedKVCache, paged_decode, paged_prefill)
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or small_f32_config()
    p_cpu = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    p_gpu = params_to(p_cpu, "cuda")
    rng = np.random.RandomState(1)
    tol = 1e-3

    # Logits: the prefills, then 8 decode steps (the paged kernel) fed the
    # same greedy tokens.
    prompt = rng.randint(0, cfg.vocab_size, 130).tolist()
    prompts = {1: (prompt, 256), 0: (prompt[:20], 32)}
    page, Pmax = 16, 32
    live = torch.tensor(active)
    worst = 0.0
    caches, logits, last = {}, {}, [0, 0]
    with torch.inference_mode():
        for name, params, dev in (("cpu", p_cpu, "cpu"),
                                  ("cuda", p_gpu, "cuda")):
            cache = PagedKVCache.create(cfg, 2, 2 * Pmax, page, Pmax, dev)
            table = torch.arange(2 * Pmax, dtype=torch.int32).reshape(2, Pmax)
            cache = cache._replace(
                page_table=table.flip(1).contiguous().to(dev))
            for slot in (1, 0) if active[0] else (1,):
                p, bucket = prompts[slot]
                toks = torch.tensor([p + [0] * (bucket - len(p))],
                                    dtype=torch.int32, device=dev)
                pages = cache.page_table[slot, : bucket // page].long()
                logits[name, slot], cache = paged_prefill(
                    params, toks, len(p), cache, cfg, slot, pages)
            caches[name] = cache
        for slot in (1, 0) if active[0] else (1,):
            worst = max(worst, (logits["cuda", slot].cpu()
                                - logits["cpu", slot]).abs().max().item())
            last[slot] = int(logits["cpu", slot][0].argmax())
        for _ in range(8):
            for name, params, dev in (("cpu", p_cpu, "cpu"),
                                      ("cuda", p_gpu, "cuda")):
                toks = torch.tensor(last, dtype=torch.int32, device=dev)
                logits[name], caches[name] = paged_decode(
                    params, toks, caches[name], cfg, active=live.to(dev))
            worst = max(worst, (logits["cuda"].cpu()[live]
                                - logits["cpu"][live]).abs().max().item())
            last = [int(t) if a else 0
                    for t, a in zip(logits["cpu"].argmax(-1), active)]
    log(f"[{tag}] float32, TF32 off: prefill + 8 decode logits (slots "
        f"{[i for i, a in enumerate(active) if a]} live), cuda vs cpu: "
        f"max|d|={worst:.3e} (tol {tol})")
    assert worst <= tol, worst

    # Greedy tokens through the engines: 130 (flash) and 20 (plain) tokens.
    outs = {}
    for name, params, dev in (("cpu", p_cpu, "cpu"), ("cuda", p_gpu, "cuda")):
        eng = LLMEngine(cfg, params, max_batch=2, max_len=512, device=dev)
        if concurrent:
            reqs = [eng.submit(p, 8) for p in (prompt, prompt[:20])]
            outs[name] = [r.result(timeout=300) for r in reqs]
        else:
            outs[name] = [eng.generate(p, 8, timeout=300)
                          for p in (prompt, prompt[:20])]
        eng.shutdown()
    log(f"[{tag}] engine greedy tokens cuda={outs['cuda']} "
        f"cpu={outs['cpu']}")
    assert outs["cuda"] == outs["cpu"], outs


def phase_train_parity(cfg=None, tag: str = "parity"):
    """Three training steps on the card against the CPU, float32 with TF32
    off, on phase 4's model (or ``cfg``) at S = 256: the flash forward and
    backward kernels (float32 paths) run on the card, their plain versions
    on the CPU."""
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.train import AdamW, CompiledTrainStep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or small_f32_config()
    tokens = torch.tensor(np.random.RandomState(3).randint(0, 256, (1, 257)),
                          dtype=torch.int32)
    p0 = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        params = params_to(p0, "cuda") if dev == "cuda" else cpu_copy(p0)
        step = CompiledTrainStep(cfg, device=dev)
        state = AdamW().init(params)
        before = train_launches()
        losses, grads = [], []
        for _ in range(3):
            losses.append(step(params, state, tokens)[2].item())
            grads.append(cpu_copy(step.grads))
        runs[dev] = dict(losses=losses, weights=flat_tree(cpu_copy(params)),
                         grads=grads, launches={
                             k: v - before[k]
                             for k, v in train_launches().items()})
    card, cpu = runs["cuda"], runs["cpu"]
    assert not any(cpu["launches"].values()), cpu["launches"]
    assert card["launches"]["flash_fwd"] and card["launches"][
        "flash_bwd_dq"] and (card["launches"]["flash_bwd_dkv"]
                             + card["launches"]["flash_bwd_dkv_per_head"]), (
        card["launches"])
    d_loss = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
    # Step 1 starts from the same weights on both devices: its gradients
    # differ only by the order of float32 sums (~1e-6 of the largest).
    g_card, g_cpu = flat_tree(card["grads"][0]), flat_tree(cpu["grads"][0])
    g_rel = max((g_card[k] - g_cpu[k]).abs().max().item()
                / g_cpu[k].abs().max().item() for k in g_cpu)
    # AdamW on the CPU from the same weights, fed the card's gradients:
    # the card's weights follow from its gradients alone.
    replay = cpu_copy(p0)
    opt = AdamW()
    opt_state = opt.init(replay)
    for g in card["grads"]:
        opt.update(replay, g, opt_state)
    replay = flat_tree(replay)
    w_card, w_cpu = card["weights"], cpu["weights"]
    d_replay = max((replay[k] - w_card[k]).abs().max().item() for k in w_card)
    # Weights: all but 0.1% of each leaf's elements within 2e-5. AdamW
    # divides by the root of the second moment, so an element whose
    # gradient (or first moment) is near the level of the step-1
    # differences takes a step of another size on each device.
    d_max = max((w_card[k] - w_cpu[k]).abs().max().item() for k in w_cpu)
    off_share, off_g1 = 0.0, []
    for k in w_cpu:
        off = (w_card[k] - w_cpu[k]).abs() > 2e-5
        off_share = max(off_share, off.float().mean().item())
        off_g1 += zip(g_card[k][off].tolist(), g_cpu[k][off].tolist())
    tiny = sum(max(abs(a), abs(b)) < 1e-7 for a, b in off_g1)
    flips = sum((a > 0) != (b > 0) for a, b in off_g1)
    dg_max = max((g_card[k] - g_cpu[k]).abs().max().item() for k in g_cpu)
    log(f"[{tag}] train, float32, TF32 off, 3 CompiledTrainStep steps at "
        f"S=256: losses cuda {card['losses']} cpu {cpu['losses']}, "
        f"max|d loss|={d_loss:.3e} (tol 1e-4); step-1 gradients max|d| / "
        f"max|g| of the worst leaf {g_rel:.3e} (tol 2e-5; largest |d| "
        f"{dg_max:.3e}); card weights against AdamW on the CPU fed the "
        f"card's gradients: max|d| {d_replay:.3e} (tol 1e-6)")
    log(f"[{tag}] train weights after step 3, card vs CPU: largest share of "
        f"a leaf off by > 2e-5 {off_share:.2e} (tol 1e-3), max|d| "
        f"{d_max:.3e}; of the {len(off_g1)} elements off, {tiny} had a "
        f"step-1 gradient below 1e-7 on both devices, {flips} a step-1 "
        f"gradient of other signs, largest step-1 |g| "
        f"{max((max(abs(a), abs(b)) for a, b in off_g1), default=0.0):.3e}; "
        f"card launches {card['launches']}")
    assert d_loss <= 1e-4 and g_rel <= 2e-5 and d_replay <= 1e-6, (
        d_loss, g_rel, d_replay)
    assert off_share <= 1e-3, off_share


def phase_moe_parity():
    """Phases 4 and 4b on the same model with MoE layers (8 experts, top-2,
    capacity factor 1.25), with both decode slots live and the engine's
    requests one after the other, so each device routes the same batches.
    Routing is discrete: every layer's dispatch tensor must be equal on
    the card and the CPU, and some assignments must have been dropped."""
    cfg = small_f32_config(n_experts=8)
    with recorded_routing() as calls:
        phase_parity(cfg, "parity-moe", active=(True, True), concurrent=False)
        phase_train_parity(cfg, "parity-moe")
    on = {d: [c for c in calls if c[0].device.type == d]
          for d in ("cpu", "cuda")}
    assert len(on["cpu"]) == len(on["cuda"]) > 0, {
        d: len(c) for d, c in on.items()}
    differ = sum(not torch.equal(a[0], b[0].cpu())
                 for a, b in zip(on["cpu"], on["cuda"]))
    n_drop = [dropped(on[d]) for d in ("cpu", "cuda")]
    n_asg = sum(k * (d.shape[0] if m is None else int(m.sum()))
                for d, m, k, _ in on["cpu"])
    log(f"[parity-moe] routing: {len(on['cpu'])} top_k_routing calls per "
        f"device (prefill, decode, engine, train forward and its recompute);"
        f" dispatch tensors that differ card vs CPU: {differ} (tol 0); "
        f"assignments dropped for want of capacity: cpu {n_drop[0]}, cuda "
        f"{n_drop[1]} of {n_asg}")
    assert differ == 0 and n_drop[0] == n_drop[1] > 0, (differ, n_drop)


def split_blocks(t, n):
    """n contiguous sequence blocks of [B, S, H, D]."""
    Sl = t.shape[1] // n
    return [t[:, i * Sl:(i + 1) * Sl].contiguous() for i in range(n)]


def ring_blocks_fwd(qb, kb, vb):
    """Ring attention over n sequence blocks in one process, as every rank
    of an n-rank ring runs it (``ring_attention._RingFlash.forward``): the
    flash forward on each visible KV block at its global offsets, merged by
    log-sum-exp. Returns per query block (O, lse)."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.ring_attention import merge_block, visible

    n, Sl = len(qb), qb[0].shape[1]
    out = []
    for my in range(n):
        o = lse = None
        for s in range(n):
            j = (my - s) % n
            if visible(my, j, True):
                o_b, lse_b = fa.flash_attention_fwd(
                    qb[my], kb[j], vb[j], causal=True, q_offset=my * Sl,
                    kv_offset=j * Sl)
                o, lse = merge_block(o, lse, o_b, lse_b)
        out.append((o.to(qb[0].dtype), lse))
    return out


def ring_blocks_bwd(qb, kb, vb, dob, fwd):
    """The ring's backward over the same blocks
    (``ring_attention._RingFlash.backward``): the flash backward on each
    visible block with the merged O and the global lse, dq, dk and dv
    summed in float32 and cast once. Returns whole-sequence dq, dk, dv."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.ring_attention import visible

    n, Sl = len(qb), qb[0].shape[1]
    dq = [torch.zeros_like(b, dtype=torch.float32) for b in qb]
    dk = [torch.zeros_like(b, dtype=torch.float32) for b in kb]
    dv = [torch.zeros_like(b, dtype=torch.float32) for b in vb]
    for my in range(n):
        o, lse = fwd[my]
        for s in range(n):
            j = (my - s) % n
            if visible(my, j, True):
                g = fa.flash_attention_bwd(
                    qb[my], kb[j], vb[j], o, lse, dob[my], causal=True,
                    q_offset=my * Sl, kv_offset=j * Sl)
                dq[my] += g[0]
                dk[j] += g[1]
                dv[j] += g[2]
    return tuple(torch.cat(parts, dim=1).to(qb[0].dtype)
                 for parts in (dq, dk, dv))


def phase_ring(card: str):
    """Ring attention's kernel path at the 8B attention width as n = 4
    blocks of 2048 in one process, against one whole-sequence flash call.
    Tolerances: PERF.md section 2's (O 2e-2, lse 1e-3, gradients 1% of the
    largest whole-call gradient)."""
    from ray_tpu_torch.ops import flash_attention as fa

    B, S, n, H, Hkv, D = 1, 8192, 4, 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, do = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    o_ref, lse_ref = fa.flash_attention_fwd(q, k, v, causal=True)
    grads_ref = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do,
                                       causal=True)
    blocks_in = [split_blocks(t, n) for t in (q, k, v)]
    dob = split_blocks(do, n)
    # The main path: the ring's forward and backward once, counted.
    train_launches(reset=True)
    fwd = ring_blocks_fwd(*blocks_in)
    grads = ring_blocks_bwd(*blocks_in, dob, fwd)
    torch.cuda.synchronize()
    launches = train_launches()
    o = torch.cat([f[0] for f in fwd], dim=1)
    lse = torch.cat([f[1] for f in fwd], dim=1)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    rel = [((g.float() - w.float()).abs().max()
            / w.float().abs().max()).item() for g, w in zip(grads, grads_ref)]
    blocks = n * (n + 1) // 2
    want = {"flash_fwd": blocks, "flash_bwd_dq": blocks}
    log(f"[ring] causal ring attention as {n} blocks of {S // n} in one "
        f"process (B={B}, S={S}, H={H}, Hkv={Hkv}, D={D}, bf16) against one "
        f"whole-sequence flash call: max|dO|={err_o:.3e} (tol 2e-2), "
        f"max|dlse|={err_l:.3e} (tol 1e-3), dq/dk/dv max|d| / max|whole| "
        f"{rel[0]:.3e} / {rel[1]:.3e} / {rel[2]:.3e} (tol 1e-2); launches "
        f"{launches} (want {blocks} forward, {blocks} dQ, {blocks} dK/dV)")
    ring_f = device_ms(lambda: ring_blocks_fwd(*blocks_in), reps=5)
    whole_f = device_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                        reps=5)
    ring_b = device_ms(lambda: ring_blocks_bwd(*blocks_in, dob, fwd), reps=5)
    whole_b = device_ms(lambda: fa.flash_attention_bwd(
        q, k, v, o_ref, lse_ref, do, causal=True), reps=5)
    log(f"[ring] device ms on {card} (the card alone, mean of 5): forward "
        f"ring {ring_f:.4f} (its {blocks} kernels, {blocks - n} merges) vs "
        f"whole {whole_f:.4f} ({ring_f / whole_f:.2f}x); backward ring "
        f"{ring_b:.4f} vs whole {whole_b:.4f} ({ring_b / whole_b:.2f}x)")
    assert err_o <= 2e-2 and err_l <= 1e-3 and max(rel) <= 1e-2, (
        err_o, err_l, rel)
    assert {k: launches[k] for k in want} == want, launches
    assert (launches["flash_bwd_dkv"] + launches["flash_bwd_dkv_per_head"]
            == blocks), launches
    del q, k, v, do, o_ref, lse_ref, grads_ref, fwd, grads, blocks_in, dob
    torch.cuda.empty_cache()
    return launches


def phase_ep_blocks(card: str):
    """One Mixtral-8x7B layer's experts as 4 blocks of 2 in one process,
    as the ranks of an ep = 4 world run them after the global routing,
    against the whole layer. bf16; the tolerance is phase 5b's bf16 one for
    a layer (max|d| <= 2e-2 max|ref|): the blocks' outputs are summed in
    bf16 where the whole layer sums all experts in one product."""
    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.parallel import moe

    cfg = LlamaConfig.mixtral_8x7b()
    M, Fd, E = cfg.hidden_size, cfg.intermediate_size, cfg.n_experts
    T, n = 2048, 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, T, M, generator=gen, device="cuda").to(torch.bfloat16)

    def draw(shape, fan):  # as init_params draws a weight
        return (torch.randn(shape, generator=gen, device="cuda")
                * fan ** -0.5).to(torch.bfloat16)

    router = draw((M, E), M).float()
    w_gate, w_up = (draw((E, M, Fd), M) for _ in range(2))
    w_down = draw((E, Fd, M), Fd)
    kw = dict(k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    xt = x.reshape(T, M)
    per = E // n

    def whole():
        return moe.moe_ffn(x, router, w_up, w_down, w_gate=w_gate, **kw)[0]

    def blocks(dispatch, combine):
        out = None
        for b in range(n):
            e = slice(b * per, (b + 1) * per)
            part = moe.expert_block(xt, dispatch, combine, w_up[e],
                                    w_down[e], w_gate[e], first_expert=b * per)
            out = part if out is None else out + part
        return out

    with torch.inference_mode():
        with recorded_routing() as calls:
            ref = whole().reshape(T, M)
            dispatch, combine, _ = moe.route(x, router, **kw)
        got = blocks(dispatch, combine)
        same = torch.equal(calls[0][0], calls[1][0])
        d = (got.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        whole_ms = device_ms(whole, reps=5)
        blocks_ms = device_ms(lambda: blocks(dispatch, combine), reps=5)
        route_ms = device_ms(lambda: moe.route(x, router, **kw), reps=5)
    log(f"[ep] one mixtral_8x7b layer (M={M}, F={Fd}, E={E}, top-"
        f"{cfg.top_k}, capacity factor {cfg.capacity_factor}, T={T}, bf16) "
        f"as {n} expert blocks of {per} after one routing, against the "
        f"whole layer: dispatch identical {same}, {dropped(calls[:1])} of "
        f"{cfg.top_k * T} assignments dropped; max|d|={d:.3e} (tol 2e-2 x "
        f"max|ref| {top:.3f})")
    log(f"[ep] device ms on {card} (the card alone, mean of 5): whole layer "
        f"{whole_ms:.4f}; routing {route_ms:.4f} + {n} blocks {blocks_ms:.4f}"
        f" ({(route_ms + blocks_ms) / whole_ms:.2f}x the whole layer)")
    assert same and d <= 2e-2 * top, (same, d, top)
    del x, router, w_gate, w_up, w_down, dispatch, combine, ref, got, calls
    torch.cuda.empty_cache()


def phase_slice(card: str):
    """Llama-3-8B at full width served by the engine."""
    cfg, params, launches = slice_served(card)
    phase_tap_cost(cfg, params, card)
    phase_breakdown(cfg, params, card)
    serve_ckpt = phase_serve_checkpoint(cfg, params, card, SLICE["prompts"],
                                        SLICE["outs"])
    del params
    torch.cuda.empty_cache()
    return launches, serve_ckpt


def slice_served(card: str):
    """Phase 5's run: the 8B drawn on the card from seed 0 (its digest
    kept in SLICE), the flash route checked inside the model, then
    serve_six (its prompts, outputs and times kept in SLICE). Returns
    (cfg, params, launches)."""
    from ray_tpu_torch.models import LlamaConfig, forward, init_params
    from ray_tpu_torch.models import num_params

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    SLICE["digest"] = weight_digest(params)
    log(f"[slice] llama3_8b: {num_params(params) / 1e9:.3f} B params, "
        f"{cfg.num_layers} layers, bf16, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    # Full-width check of the flash route inside the model: a 128-token
    # prompt through forward() with the kernel and with plain attention.
    rng = np.random.RandomState(0)
    toks = torch.tensor(rng.randint(0, cfg.vocab_size, (1, 128)),
                        dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        lf, _ = forward(params, toks, cfg)
        lp, _ = forward(params, toks,
                        dataclasses.replace(cfg, use_flash=False))
    d = (lf[0, -1] - lp[0, -1]).abs().max().item()
    tol = 0.25
    log(f"[slice] forward logits, flash vs plain attention (bf16, 32 "
        f"layers): max|d|={d:.3e} (tol {tol}); |logits| max "
        f"{lp.abs().max().item():.2f}")
    assert torch.isfinite(lf).all() and d <= tol, d

    launches, prompts, outs = serve_six(cfg, params, card, "slice", rng)
    SLICE.update(prompts=prompts, outs=outs)
    return cfg, params, launches


SERVE_ENGINE = dict(max_batch=4, max_len=512, page_size=16)
SERVE_LENS = [40, 100, 300, 60, 130, 200]  # phase 5's six prompts
SERVE_NEW = [16, 32, 24, 32, 16, 24]  # and their new tokens
# Phase 5's run, which phase 16 holds the served 8B against: the weights'
# digest, the prompts and greedy outputs, TTFT ms and ms per decode step.
SLICE = {}


def weight_digest(params):
    """(shape, float64 sum, sha256 of the first 65536 values) of every
    weight tensor, in a fixed order: equal only for the same weights."""
    out = []
    for t in tree_tensors(params):
        head = t.reshape(-1)[:1 << 16].float().cpu().numpy().tobytes()
        out.append((tuple(t.shape), torch.sum(t, dtype=torch.float64).item(),
                    hashlib.sha256(head).hexdigest()[:16]))
    return out


def serve_six(cfg, params, card: str, tag: str, rng, eng=None,
              prompts=None):
    """Phase 5's run: LLMEngine(max_batch=4, max_len=512, page_size=16)
    serving six concurrent requests, more than the slots, with the serving
    kernels' launch counters reset just before and read just after.
    ``eng`` is an engine built elsewhere (phase 8's, inside a deployment)
    and ``prompts`` phase 5's, both drawn from ``rng`` if not given.
    Returns (launches, prompts, the six outputs)."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve.llm import LLMEngine

    built = eng is None
    compiles0 = compile_counts()
    if built:
        eng = LLMEngine(cfg, params, device="cuda", **SERVE_ENGINE)
    eng.generate(rng.randint(0, cfg.vocab_size, 40).tolist(), 2)  # warm-up
    lens, new = SERVE_LENS, SERVE_NEW
    if prompts is None:
        prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    steps0 = eng.stats()["decode_steps"]
    times = [[] for _ in lens]

    def consume(i, req):
        for _tok in req.tokens(timeout=600):
            times[i].append(time.perf_counter())
        times[i].append(time.perf_counter())  # end of stream

    fa.launches = 0
    pa.launches = 0
    t_start = time.perf_counter()
    reqs = [eng.submit(p, n) for p, n in zip(prompts, new)]
    threads = [threading.Thread(target=consume, args=(i, r))
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    outs = [r.result(timeout=600) for r in reqs]
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    wall = time.perf_counter() - t_start
    launches = {"flash_fwd": fa.launches, "paged_decode": pa.launches}
    stats = eng.stats()
    eng.shutdown()

    for i, (out, n) in enumerate(zip(outs, new)):
        assert len(out) == n and all(0 <= t < cfg.vocab_size for t in out), (
            i, out)
    done = [ts[-1] for ts in times]
    first = [r._t0 + r.ttft_s for r in reqs]
    # Requests 4 and 5 found every slot taken: each starts only after
    # one of the first four has finished and freed its slot.
    assert min(first[4], first[5]) >= min(done[:4]), (first, done)
    assert launches["flash_fwd"] > 0 and launches["paged_decode"] > 0, launches
    assert stats["free_pages"] == stats["total_pages"], stats
    assert stats["active_slots"] == 0, stats
    steps = stats["decode_steps"] - steps0
    decode_tokens = sum(len(o) - 1 for o in outs)
    t_dec0 = min(ts[0] for ts in times)
    t_dec1 = max(ts[-2] for ts in times)
    tps = decode_tokens / (t_dec1 - t_dec0)
    ttft = [r.ttft_s * 1e3 for r in reqs]
    if tag == "slice":
        SLICE.update(ttft_ms=ttft, step_ms=(t_dec1 - t_dec0) / steps * 1e3)
    L = cfg.num_layers
    log(f"[{tag}] 6 requests (prompts {lens}, new {new}) done in {wall:.2f} "
        f"s on {card}: {steps} decode steps, {decode_tokens} decode tokens, "
        f"{tps:.1f} decode tok/s, {(t_dec1 - t_dec0) / steps * 1e3:.2f} "
        f"ms/step")
    log(f"[{tag}] TTFT ms per request (incl. queueing): "
        f"{[round(t, 1) for t in ttft]}; first-token order ok, pages all "
        f"free ({stats['free_pages']}/{stats['total_pages']})")
    log(f"[{tag}] launches on the main path: {launches} ({L} layers: "
        f"flash {launches['flash_fwd'] / L:.0f} prefills with bucket >= 128,"
        f" paged {launches['paged_decode'] / L:.0f} decode steps)")
    if built:  # phase 10: the engine's compile telemetry
        count, secs = (grown(a, b) for a, b in zip(compile_counts(),
                                                    compiles0))
        buckets = sorted({eng._bucket(n) for n in [40] + lens})
        want = {"decode_step": 1.0, "prefill": float(len(buckets))}
        log(f"[telemetry] {tag} engine compiles by fn {count} (want {want}: "
            f"one decode shape, prefill buckets {buckets}); compile seconds "
            + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
            + f"; on {card}")
        assert count == want, (count, want)
    return launches, prompts, outs


def phase_slice_moe(card: str):
    """Mixtral-8x7B at full width, 16 layers, served by the engine."""
    from ray_tpu_torch.models import LlamaConfig, forward, init_params
    from ray_tpu_torch.models import num_params
    from ray_tpu_torch.models.llama import _layer, embed, layer_params
    from ray_tpu_torch.parallel.moe import moe_ffn

    cfg = dataclasses.replace(LlamaConfig.mixtral_8x7b(), num_layers=16)
    L, T = cfg.num_layers, 128
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    log(f"[slice-moe] mixtral_8x7b cut to {L} of 32 layers: "
        f"{num_params(params) / 1e9:.3f} B params, {cfg.n_experts} experts, "
        f"top-{cfg.top_k}, capacity factor {cfg.capacity_factor}, bf16 "
        f"(router float32), drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    # One full-width layer: moe_ffn in bf16 against float32 from the same
    # bf16 input. The router product is float32 in both, so the dispatch
    # must be identical. Tolerance, set before the first run from the
    # same comparison at 1/4 and 1/2 width on the CPU (max|d| 0.5-0.7% of
    # max|ref|, relative RMS 0.46%): max|d| <= 2e-2 max|ref| and relative
    # RMS <= 1e-2.
    lp = layer_params(params, 0)
    x = torch.randn(1, T, cfg.hidden_size,
                    generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda").to(cfg.dtype)
    kw = dict(k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    with torch.inference_mode(), recorded_routing() as calls:
        out16, aux16 = moe_ffn(x, lp["router"], lp["w_up"], lp["w_down"],
                               w_gate=lp["w_gate"], **kw)
        out32, aux32 = moe_ffn(x.float(), lp["router"], lp["w_up"].float(),
                               lp["w_down"].float(),
                               w_gate=lp["w_gate"].float(), **kw)
    d = (out16.float() - out32).abs()
    ref = out32.abs().max().item()
    rms = (d.pow(2).mean().sqrt() / out32.pow(2).mean().sqrt()).item()
    same = torch.equal(calls[0][0], calls[1][0])
    log(f"[slice-moe] one layer's moe_ffn, bf16 vs float32 on the card "
        f"(T={T}): dispatch identical {same}, {dropped(calls[:1])} of "
        f"{cfg.top_k * T} assignments dropped; max|d|={d.max().item():.3e} "
        f"(tol 2e-2 x max|ref| {ref:.3f}), relative RMS {rms:.3e} (tol "
        f"1e-2); aux {aux16.item():.6f} / {aux32.item():.6f}")
    assert same and d.max().item() <= 2e-2 * ref and rms <= 1e-2, (
        same, d.max().item(), ref, rms)
    del lp, x, out16, out32, calls, d
    torch.cuda.empty_cache()

    # The flash route inside the model, flash kernel against plain
    # attention on a 128-token prompt. A routing decision (the router's
    # top-k experts of a token) can flip on a rounding difference; a flip
    # moves that token's output by O(1), changes later layers' inputs, and
    # shifts the queue positions, hence the drops, of other tokens. So the
    # flips are counted layer by layer from the same input (the flash
    # run's): at most 1% of the decisions may differ. Then two whole
    # forwards: logits are held to phase 5's 0.25 at the tokens none of
    # whose decisions (the experts that keep it) differ in any layer.
    plain = dataclasses.replace(cfg, use_flash=False)
    rng = np.random.RandomState(0)
    toks = torch.tensor(rng.randint(0, cfg.vocab_size, (1, T)),
                        dtype=torch.int32, device="cuda")
    positions = torch.arange(T, device="cuda")
    with torch.inference_mode(), recorded_routing() as calls:
        x = embed(params, toks, cfg)
        for i in range(L):
            _layer(plain, positions, x, layer_params(params, i))
            x, _ = _layer(cfg, positions, x, layer_params(params, i))
    flips = [int((a[3] != b[3]).any(-1).sum())
             for a, b in zip(calls[0::2], calls[1::2])]
    with torch.inference_mode(), recorded_routing() as calls:
        lf, aux_f = forward(params, toks, cfg)
        lpl, _ = forward(params, toks, plain)
    assert len(calls) == 2 * L, len(calls)
    differ = torch.stack([(kept_experts(a[0]) != kept_experts(b[0])).any(-1)
                          for a, b in zip(calls[:L], calls[L:])])  # [L, T]
    clean = ~differ.any(0)
    d = (lf[0, clean] - lpl[0, clean]).abs().max().item()
    tol = 0.25
    log(f"[slice-moe] routing, flash vs plain attention (bf16, {L} layers, "
        f"{T} tokens), each layer from the same input: tokens whose top-"
        f"{cfg.top_k} experts differ, per layer {flips}: {sum(flips)} of "
        f"{L * T} decisions (tol 1%)")
    log(f"[slice-moe] whole forwards, flash vs plain: tokens kept by other "
        f"experts, per layer {differ.sum(1).tolist()}; logits at the "
        f"{int(clean.sum())} tokens with no differing decision: max|d|="
        f"{d:.3e} (tol {tol}); |logits| max {lpl.abs().max().item():.2f}; "
        f"aux {aux_f.item():.4f}; dropped {dropped(calls[:L])} of "
        f"{cfg.top_k * T * L} assignments")
    assert torch.isfinite(lf).all() and sum(flips) <= 0.01 * L * T, flips
    assert clean.any() and d <= tol, (int(clean.sum()), d)
    del x, lf, lpl, calls, differ

    launches = serve_six(cfg, params, card, "slice-moe", rng)[0]
    phase_breakdown(cfg, params, card)
    del params
    torch.cuda.empty_cache()
    return launches


def _grad_norms(grads):
    def norm(t):  # in float32 without a float32 copy of the leaf
        return torch.linalg.vector_norm(t, dtype=torch.float32).item()

    return {k: norm(v) for k, v in flat_tree(grads).items()}


def phase_tap_cost(cfg, params, card: str):
    """Phase 10: what the decode step's telemetry tap costs. Phase 5's
    engine (max_len 2048, to hold the steps) with its loop stopped: four
    requests (40-token prompts) prefilled by ``_admit`` in this thread,
    then 64-step windows of the tapped decode step (``eng._decode``, a
    ring of 64) and of the bare step (its ``__wrapped_fn__``), three
    rounds of (tap, bare, bare, tap), then the two alternating a step at
    a time. Each step ends on the host (the sampled tokens are copied
    back), so a step's wall time is its own. The wrapper's own cost is
    timed on a no-op beside it."""
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.util.device_metrics import instrumented_step

    eng = LLMEngine(cfg, params, device="cuda",
                    **dict(SERVE_ENGINE, max_len=2048))
    eng.shutdown()  # this thread drives the steps
    rng = np.random.RandomState(5)
    for _ in range(4):
        eng.submit(rng.randint(0, cfg.vocab_size, 40).tolist(), 2000)
    active = np.ones(4, dtype=bool)
    tapped = eng._decode
    bare = tapped.__wrapped_fn__

    def timed(fn):
        t0 = time.perf_counter()
        fn(active)
        return (time.perf_counter() - t0) * 1e3

    rounds = []
    with torch.inference_mode():
        eng._admit()
        assert len(eng._slot_req) == 4, eng.stats()
        for fn in (bare, tapped) * 4:  # warm-up, and the tap's one compile
            fn(active)
        for _ in range(3):  # 64-step windows: tap, bare, bare, tap
            rounds.append([float(np.mean([timed(fn) for _ in range(64)]))
                           for fn in (tapped, bare, bare, tapped)])
        # Then the two in alternation, a step each, which goes first
        # alternating too: the host's drift (2x between runs, PERF.md
        # section 7) falls on both alike.
        alt = {"tap": [], "bare": []}
        for i in range(256):
            for which in (("tap", "bare"), ("bare", "tap"))[i % 2]:
                alt[which].append(timed(tapped if which == "tap" else bare))
    ratios = [(r[0] + r[3]) / (r[1] + r[2]) for r in rounds]
    med = {k: float(np.median(v)) for k, v in alt.items()}

    def tap_probe(active):
        return active

    probe = instrumented_step(tap_probe, tap_stride=64,
                              signature=lambda active: active.shape)
    cost = {}
    for name, fn in (("bare", tap_probe), ("tap", probe)) * 2:
        t0 = time.perf_counter()
        for _ in range(100_000):
            fn(active)
        cost[name] = (time.perf_counter() - t0) / 100_000 * 1e6
    ratio = float(np.median(ratios))
    alt_ratio = med["tap"] / med["bare"]
    log(f"[telemetry] decode step B=4 (llama3_8b), 64-step windows (tap, "
        f"bare, bare, tap) x 3, ms/step: "
        f"{[[round(v, 2) for v in r] for r in rounds]}; tap / bare by "
        f"round {[round(v, 4) for v in ratios]}, median {ratio:.4f} "
        f"({'within' if abs(ratio - 1) <= 0.02 else 'NOT within'} 2%); "
        f"alternating a step each (256 each): median {med['tap']:.3f} / "
        f"{med['bare']:.3f} ms = {alt_ratio:.4f} "
        f"({'within' if abs(alt_ratio - 1) <= 0.02 else 'NOT within'} "
        f"2%); the wrapper on a no-op {cost['tap'] - cost['bare']:.3f} µs "
        f"a call; the tap's compiles {tapped.cache_size()}; on {card}")
    assert tapped.cache_size() == 1
    del eng
    torch.cuda.empty_cache()


def phase_telemetry(card: str):
    """Phase 10's last part: the spans of phases 8 and 8b written by
    ``timeline(path)`` and read back as JSON, and the exposition document,
    which must hold every ray_tpu_device_* series that was touched."""
    from ray_tpu_torch.util import metrics, prometheus, timeline
    from ray_tpu_torch.util.prometheus import _fmt_labels

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "smoke_timeline.json")
    events = timeline.timeline(path)
    with open(path) as f:
        reread = json.load(f)
    assert reread == events
    for trace, names in SPANS.items():
        got = [e["name"] for e in reread if e["args"]["trace_id"] == trace]
        assert got == names, (got, names)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in reread)
    kinds = [n.split(":")[0] for names in SPANS.values() for n in names]
    log(f"[telemetry] timeline({path!r}): {len(reread)} chrome-trace events "
        f"re-read as JSON, the {len(kinds)} spans of phases 8 and 8b among "
        f"them ({ {k: kinds.count(k) for k in sorted(set(kinds))} }); on "
        f"{card}")
    text = prometheus.render()
    report = metrics.get_metrics_report()
    touched = sorted(n for n in report if n.startswith("ray_tpu_device_"))
    for name in touched:
        assert f"# TYPE {name} " in text, name
        for tags in report[name]["series"]:
            assert f"\n{name}{_fmt_labels(tags)} " in text, (name, tags)
    log(f"[telemetry] prometheus.render(): {len(text.splitlines())} lines, "
        f"{len(touched)} ray_tpu_device_* metrics touched, every series "
        f"present; on {card}:")
    for line in text.splitlines():
        if line.startswith("ray_tpu_device_"):
            log(f"[telemetry]   {line}")
    assert len(touched) == 9, touched


# Kernel name -> its launch counter in ray_tpu_torch.ops.flash_attention.
TRAIN_COUNTERS = {"flash_fwd": "launches", "flash_bwd_dq": "bwd_dq_launches",
                  "flash_bwd_dkv": "bwd_dkv_launches",
                  "flash_bwd_dkv_per_head": "bwd_dkv_per_head_launches"}


def train_launches(reset: bool = False):
    """The training path's launch counts, set to 0 first if ``reset``."""
    from ray_tpu_torch.ops import flash_attention as fa

    if reset:
        for attr in TRAIN_COUNTERS.values():
            setattr(fa, attr, 0)
    return {k: getattr(fa, attr) for k, attr in TRAIN_COUNTERS.items()}


def phase_train(card: str, cfg=None, tag: str = "train", name="llama3_8b",
                measured: int = 5, short_step: bool = True,
                mesh: bool = False):
    """Llama-3-8B at full width and depth (or ``cfg``) trained on the card:
    2 warm-up and ``measured`` steps at B = 1, S = 2048, then, with
    ``short_step``, one at B = 8, S = 512. With ``mesh`` the step runs
    through ``make_mesh()`` (world size 1, NCCL), and afterwards the same
    step without a mesh is timed in turns with it on the same weights."""
    import torch.distributed as dist

    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.models.llama import hidden_forward
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import CompiledTrainStep

    cfg = cfg or LlamaConfig.llama3_8b()  # remat "full", loss_chunk 512
    assert cfg.remat_policy == "full" and cfg.loss_chunk == 512
    B, S = 1, 2048
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    compiles0 = compile_counts()
    t0 = time.perf_counter()
    step = CompiledTrainStep(cfg, learning_rate=1e-3,
                             mesh=make_mesh() if mesh else None)
    params, opt_state = step.init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    P = step.num_params(params)
    gb = 1e9
    log(f"[{tag}] {name}: {P / 1e9:.3f} B params, {cfg.num_layers} "
        f"layers, bf16, AdamW(1e-3); params, grads and moments allocated in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / gb:.2f} GB on the card"
        + (f"; through the mesh {step.mesh} on a {dist.get_backend()} group "
           f"of {dist.get_world_size()}" if mesh else ""))
    saved = cfg.num_layers * B * S * cfg.hidden_size * 2
    log(f"[{tag}] memory reckoning: bf16 params {2 * P / gb:.1f} GB + grads "
        f"{2 * P / gb:.1f} GB + bf16 m and v {4 * P / gb:.1f} GB = "
        f"{8 * P / gb:.1f} GB persistent, + {saved / gb:.2f} GB of saved "
        f"layer inputs ({cfg.num_layers} x [{B}, {S}, {cfg.hidden_size}] "
        f"bf16) + under 2 GB for one layer's recompute: under 80 GB")
    tokens = torch.tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S + 1)), dtype=torch.int32, device="cuda")
    if mesh:  # this rank's window: at world size 1 the whole batch
        tokens = step.token_sharding().cut(tokens)
    if cfg.n_experts:
        with torch.inference_mode():
            aux = hidden_forward(params, tokens[:, :-1], cfg,
                                 mesh=step.mesh)[1].item()
        log(f"[{tag}] MoE load-balancing aux loss at step 0 (summed over "
            f"{cfg.num_layers} layers, 1.0 a layer when balanced): "
            f"{aux:.5f}; the loss adds {step.aux_weight} x it")
        assert np.isfinite(aux) and aux > 0, aux

    # Full-width check at step 0: flash kernels against plain attention,
    # one after the other through the step's one gradient buffer. bf16
    # through 32 layers: both round P to bf16 before PV, in other places
    # and orders, so the loss may differ by 1e-2 and a gradient norm by 5%.
    with recorded_routing() as routed:
        loss_f, grads = step.value_and_grad(params, tokens)
    norms_f = _grad_norms(grads)
    loss_f = loss_f.item()
    if mesh and cfg.n_experts:
        check_dispatch_without_mesh(step, params, tokens, routed, loss_f,
                                    tag)
    del routed
    step.cfg = dataclasses.replace(cfg, use_flash=False)
    loss_p, grads = step.value_and_grad(params, tokens)
    norms_p = _grad_norms(grads)
    loss_p = loss_p.item()
    step.cfg = cfg
    rel = {k: abs(norms_f[k] - norms_p[k]) / max(norms_p[k], 1e-12)
           for k in norms_p}
    worst = max(rel, key=rel.get)
    log(f"[{tag}] step-0 loss flash {loss_f:.5f} vs plain attention "
        f"{loss_p:.5f}: |d|={abs(loss_f - loss_p):.3e} (tol 1e-2); gradient "
        f"norms of {len(rel)} leaves, worst relative difference "
        f"{rel[worst]:.3e} at {worst} (tol 5e-2); norms flash "
        + ", ".join(f"{k} {v:.4g}" for k, v in sorted(norms_f.items())))
    # Checked after the measured steps below, so a failing run still
    # prints its numbers; the phase fails all the same.
    checks = [(np.isfinite(loss_f) and abs(loss_f - loss_p) <= 1e-2,
               ("loss", loss_f, loss_p)),
              (all(np.isfinite(v) and v > 0 for v in norms_f.values()),
               ("norms", norms_f)),
              (rel[worst] <= 5e-2, ("norm", worst, rel[worst]))]

    # The main path: warm-up, measured steps, one short-sequence step.
    train_launches(reset=True)
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []
    for i in range(2 + measured):
        before = train_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, loss = step(params, opt_state, tokens)
        loss = loss.item()  # synchronises
        times.append(time.perf_counter() - t)
        losses.append(loss)
        per_step.append({k: v - before[k]
                         for k, v in train_launches().items()})
        assert np.isfinite(loss), (i, loss)
    if short_step:
        # B = 8, S = 512: the shape where the grid rule takes the KV-head
        # grid.
        short = torch.tensor(np.random.RandomState(1).randint(
            0, cfg.vocab_size, (8, 513)), dtype=torch.int32, device="cuda")
        before = train_launches()
        _, _, loss_short = step(params, opt_state, short)
        short_launches = {k: v - before[k]
                          for k, v in train_launches().items()}
        assert np.isfinite(loss_short.item())
    launches = train_launches()
    peak = torch.cuda.max_memory_allocated()
    telemetry_train(step, compiles0, 1 + short_step, card, tag)
    ms = float(np.median(times[2:])) * 1e3
    if mesh:
        compare_without_mesh(step, params, opt_state, tokens, card, tag)
    tps = B * S / (ms / 1e3)
    L = cfg.num_layers
    # MoE: the parameters a token passes through (top_k of the experts).
    P_active = P - L * (cfg.n_experts - cfg.top_k) * 3 * (
        cfg.hidden_size * cfg.intermediate_size) if cfg.n_experts else P
    flops_per_token = 6 * P_active + 12 * L * S * (cfg.num_heads * cfg.dh)
    mfu = tps * flops_per_token / BF16_FLOPS_PER_S

    def want_for(b, s):  # launches of one step: the grid rule's dK/dV grid
        per_head = fa.dkv_per_head(
            b, cfg.num_heads, cfg.num_kv_heads, s, s, cfg.dh,
            dtype=torch.bfloat16, causal=True,
            sms=torch.cuda.get_device_properties(0).multi_processor_count)
        return {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                "flash_bwd_dkv": 0 if per_head else L,
                "flash_bwd_dkv_per_head": L if per_head else 0}

    want = want_for(B, S)
    short_note = ""
    if short_step:
        want_short = want_for(short.shape[0], short.shape[1] - 1)
        short_note = f"; B=8 S=512 step loss {loss_short.item():.4f}"
    log(f"[{tag}] losses over 2 warm-up + {measured} measured steps (same "
        f"batch): {[round(x, 4) for x in losses]}{short_note}")
    log(f"[{tag}] B=1 S=2048 on {card}: {ms:.1f} ms/step (median of "
        f"{measured}, synchronised; all {[round(t * 1e3, 1) for t in times]})"
        f", {tps:.0f} tokens/s, MFU {mfu:.4f} (6P + 12 L S H Dh = "
        f"{flops_per_token / 1e9:.2f} GFLOP/token against 989 TFLOP/s"
        + (f"; P the {P_active / 1e9:.3f} B parameters a token passes "
           f"through, top-{cfg.top_k} of {cfg.n_experts} experts"
           if cfg.n_experts else "") + "); "
        f"peak {peak / gb:.2f} GB allocated, "
        f"{torch.cuda.max_memory_reserved() / gb:.2f} GB reserved")
    log(f"[{tag}] launches per S=2048 step: {per_step[-1]} (want {want})"
        + (f"; B=8 S=512 step: {short_launches} (want {want_short})"
           if short_step else "") + f"; whole run {launches}")
    assert all(p == want for p in per_step), per_step
    if short_step:
        assert short_launches == want_short, short_launches
    phase_train_breakdown(step, params, opt_state, tokens)
    for ok, what in checks:
        assert ok, what
    del params, opt_state, step
    torch.cuda.empty_cache()
    if mesh:
        dist.destroy_process_group()
    return launches


def telemetry_train(step, compiles0, shapes: int, card: str, tag: str):
    """Phase 10 after a train phase's main path: one compile per token
    shape the step ran, and the step's memory snapshot against
    torch.cuda.memory_stats read at the same moment, the card's total
    and the published gauges."""
    from ray_tpu_torch.util import device_metrics

    count, secs = (grown(a, b) for a, b in zip(compile_counts(), compiles0))
    stats = step.compile_stats()
    log(f"[telemetry] {tag} step compiles by fn {count}, compile_stats "
        f"{stats} (want {shapes}, one a token shape); compile seconds "
        f"{secs.get('train_step', 0.0):.3f}; on {card}")
    assert count == {"train_step": float(shapes)}, count
    assert stats == {"fn": "train_step", "executables": shapes}, stats
    snap = step.memory_snapshot()
    raw = torch.cuda.memory_stats()
    total = torch.cuda.mem_get_info()[1]
    pairs = {"bytes_in_use": "allocated_bytes.all.current",
             "peak_bytes_in_use": "allocated_bytes.all.peak",
             "bytes_reserved": "reserved_bytes.all.current",
             "peak_bytes_reserved": "reserved_bytes.all.peak"}
    (info,) = device_metrics.sample()
    gauges = {k: counts_by(f"ray_tpu_device_memory_{k}", "device")["gpu:0"]
              for k in ("bytes_in_use", "peak_bytes", "limit_bytes",
                        "fragmentation_ratio")}
    log(f"[telemetry] {tag} memory_snapshot() {snap}; torch.cuda."
        f"memory_stats {({v: raw[v] for v in pairs.values()})}; card total "
        f"{total} (mem_get_info); gauges {gauges}; on {card}")
    assert all(snap[k] == raw[v] for k, v in pairs.items()), (snap, raw)
    assert abs(snap["bytes_limit"] - total) <= 0.01 * total, snap
    assert 0.0 <= snap["fragmentation"] <= 1.0, snap
    assert info["bytes_in_use"] == snap["bytes_in_use"], (info, snap)
    assert gauges["bytes_in_use"] == snap["bytes_in_use"]
    assert gauges["peak_bytes"] == snap["peak_bytes_in_use"]
    assert gauges["limit_bytes"] == snap["bytes_limit"]
    assert abs(gauges["fragmentation_ratio"] - snap["fragmentation"]) \
        <= 5e-5, (gauges, snap)


def check_dispatch_without_mesh(step, params, tokens, routed, loss, tag):
    """Step 0's routing through the mesh (``routed``: the gathered global
    logits routed in the forward and in the recompute) against the same
    step without a mesh on the same weights: every dispatch equal."""
    from ray_tpu_torch.train import CompiledTrainStep

    plain = CompiledTrainStep(step.cfg, learning_rate=1e-3, device=step.device)
    plain._grads = step.grads  # the same buffers: no second copy
    with recorded_routing() as without:
        loss_plain = plain.value_and_grad(params, tokens)[0].item()
    same = len(routed) == len(without) and all(
        torch.equal(a[0], b[0]) for a, b in zip(routed, without))
    log(f"[{tag}] step-0 routing through the mesh against the step without "
        f"it: {len(routed)} / {len(without)} top_k_routing calls (forward "
        f"and recompute), dispatch identical {same}, "
        f"{dropped(routed[:step.cfg.num_layers])} assignments dropped in "
        f"the forward; loss {loss:.5f} vs {loss_plain:.5f}")
    assert same, (len(routed), len(without))


def compare_without_mesh(step, params, opt_state, tokens, card, tag):
    """The mesh step against the same step without a mesh, on the same
    weights and gradient buffers, in turns (mesh, plain, plain, mesh; 3
    steps each, after the main path's): median ms/step and peak memory of
    each."""
    from ray_tpu_torch.train import CompiledTrainStep

    plain = CompiledTrainStep(step.cfg, learning_rate=1e-3, device=step.device)
    plain._grads = step.grads  # the same buffers: no second 14.5 GB
    runs = {"mesh": [], "plain": []}
    peaks = {"mesh": 0, "plain": 0}
    for which in ("mesh", "plain", "plain", "mesh"):
        run = step if which == "mesh" else plain
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(params, opt_state, tokens)[2].item()
            runs[which].append(time.perf_counter() - t)
        peaks[which] = max(peaks[which], torch.cuda.max_memory_allocated())
    ms = {k: float(np.median(v)) * 1e3 for k, v in runs.items()}
    log(f"[{tag}] in turns on {card} (mesh, none, none, mesh; 3 steps each):"
        f" through the world-size-1 mesh {ms['mesh']:.1f} ms/step, peak "
        f"{peaks['mesh'] / 1e9:.2f} GB; without a mesh {ms['plain']:.1f} "
        f"ms/step, peak {peaks['plain'] / 1e9:.2f} GB "
        f"({ms['mesh'] / ms['plain']:.3f}x)")


def phase_train_moe(card: str):
    """Mixtral-8x7B at full width, cut to 4 layers, trained on the card."""
    from ray_tpu_torch.models import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.mixtral_8x7b(), num_layers=4)
    return phase_train(card, cfg, "train-moe",
                       "mixtral_8x7b cut to 4 of 32 layers", measured=3,
                       short_step=False, mesh=True)


def phase_pipeline(card: str):
    """The GPipe schedule on the card: ``pipeline_apply`` through
    ``make_mesh()`` at world size 1 (pp = 1), the 8B's blocks as the stage
    function (4 layers at full width), B = 4, S = 2048, 4 microbatches,
    remat on. Forward and backward against the same layers on the whole
    batch without the pipeline: hidden state within 2e-2 of the largest
    and gradient norms within 5% (bf16: the microbatches' products differ
    in shape from the whole batch's), exact launches, both times."""
    import torch.distributed as dist

    from ray_tpu_torch.models import LlamaConfig, init_params
    from ray_tpu_torch.models.llama import _layer
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=4)
    L, B, S, n_micro = cfg.num_layers, 4, 2048, 4
    mesh = make_mesh()
    layers = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")["layers"]
    stage = {k: v.unsqueeze(0).requires_grad_() for k, v in layers.items()}
    positions = torch.arange(S, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(B, S, cfg.hidden_size, generator=gen,
                    device="cuda").to(cfg.dtype)
    w = torch.randn(B, S, cfg.hidden_size, generator=gen, device="cuda")

    def stage_fn(p, h):
        for i in range(L):
            h, _ = _layer(cfg, positions, h, {k: v[i] for k, v in p.items()})
        return h

    def run(piped: bool):
        for v in stage.values():
            v.grad = None
        if piped:
            h = pipeline_apply(stage_fn, stage, x, mesh,
                               n_microbatches=n_micro, remat=True)
        else:
            h = stage_fn({k: v[0] for k, v in stage.items()}, x)
        ((h.float() * w).sum() / mesh.size()).backward()
        return h.detach(), {k: torch.linalg.vector_norm(
            v.grad, dtype=torch.float32).item() for k, v in stage.items()}

    ref, norms_ref = run(False)
    train_launches(reset=True)
    got, norms = run(True)
    torch.cuda.synchronize()
    launches = train_launches()
    d = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    rel = {k: abs(norms[k] - norms_ref[k]) / norms_ref[k] for k in norms}
    worst = max(rel, key=rel.get)
    per_head = fa.dkv_per_head(
        B // n_micro, cfg.num_heads, cfg.num_kv_heads, S, S, cfg.dh,
        dtype=torch.bfloat16, causal=True,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    calls = n_micro * L  # layer calls of the schedule: ticks x layers
    want = {"flash_fwd": 2 * calls, "flash_bwd_dq": calls,
            "flash_bwd_dkv": 0 if per_head else calls,
            "flash_bwd_dkv_per_head": calls if per_head else 0}
    times = {True: [], False: []}
    for piped in (True, False, False, True):
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(piped)
            torch.cuda.synchronize()
            times[piped].append(time.perf_counter() - t)
    ms = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    log(f"[pipeline] pipeline_apply through {mesh} on a "
        f"{dist.get_backend()} group of {dist.get_world_size()}: llama3_8b "
        f"blocks, {L} layers, B={B}, S={S}, {n_micro} microbatches, remat; "
        f"against the layers on the whole batch: hidden max|d|={d:.3e} (tol "
        f"2e-2 x max|ref| {top:.3f}); gradient norms of {len(rel)} leaves, "
        f"worst relative difference {rel[worst]:.3e} at {worst} (tol 5e-2); "
        f"launches {launches} (want {want})")
    log(f"[pipeline] forward + backward on {card} (synchronised, median of "
        f"4, in turns): pipeline {ms[True]:.1f} ms, whole batch without it "
        f"{ms[False]:.1f} ms ({ms[True] / ms[False]:.3f}x)")
    assert d <= 2e-2 * top and rel[worst] <= 5e-2, (d, top, rel[worst])
    assert launches == want, (launches, want)
    del layers, stage, x, w, ref, got
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return launches


def phase_train_breakdown(step, params, opt_state, tokens):
    """Device time of one training step by kind, against its wall time."""
    from torch.profiler import ProfilerActivity, profile

    step(params, opt_state, tokens)
    torch.cuda.synchronize()
    counts0 = collective_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, opt_state, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    calls, nbytes = (grown(a, b) for a, b in zip(collective_counts(),
                                                  counts0))
    _report("train step B=1 S=2048", wall, _device_kernels(prof, 1),
            kinds=TRAIN_KINDS, top=12, moe=_moe_ranges(prof, 1))
    nccl = _host_report(prof)
    if step.mesh is not None:  # phase 10: the step's collectives, counted
        n = sum(calls.values())
        log(f"[telemetry] collectives a step through the mesh, counted by "
            f"the port (a Python-level call each): {n} calls, by op "
            f"{ {k: int(v) for k, v in calls.items()} }, bytes by op "
            f"{ {k: int(v) for k, v in nbytes.items()} }; the profiler's "
            f"NCCL calls (nccl:* ranges) in the same step: {nccl} "
            f"({nccl / max(n, 1):.3f} a counted call: an all-reduce over k "
            f"axes is one counted call and k NCCL calls, and the backward's "
            f"transposes are NCCL calls the port does not count)")
        assert n > 0 and set(calls) <= {"allreduce", "allgather",
                                        "broadcast"}, calls


def _host_report(prof):
    """The host side of a profiled step: collective calls (the c10d
    ``nccl:*`` ranges) with their CPU time, and the ops with the most CPU
    time of their own."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    coll = [e for e in rows if e.key.startswith(("nccl:", "c10d::"))]
    top = sorted(rows, key=lambda e: -e.self_cpu_time_total)[:8]
    log("[breakdown] host: collective calls " + (", ".join(
        f"{e.key} x{e.count} {e.cpu_time_total / 1e3:.1f} ms" for e in coll)
        or "none") + "; most CPU time of their own: " + ", ".join(
        f"{e.key[:40]} x{e.count} {e.self_cpu_time_total / 1e3:.1f} ms"
        for e in top))
    return sum(e.count for e in coll if e.key.startswith("nccl:"))


def _device_kernels(prof, steps: int):
    """(name, ms per step, launches per step) of every device kernel. A
    user annotation (torch.optim's ``Optimizer.step#AdamW.step``) carries
    the device time of the kernels inside it and is left out."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=lambda r: -r[1])


def _moe_ranges(prof, steps: int):
    """Device ms per step inside the MoE layer's profiler ranges, or None
    without MoE: "expert GEMM" (``moe.experts``: the three expert products
    and the SiLU) and "routing/dispatch/combine" (``moe.ffn`` less
    ``moe.experts``), and the kernel launches a step inside each. The CPU
    side of a range carries the kernels launched inside it; a backward
    pass runs outside them."""
    from torch.autograd import DeviceType

    def launches(e):
        return len(e.kernels) + sum(launches(c) for c in e.cpu_children)

    names = ("moe.ffn", "moe.experts")
    t = {e.key: e.device_time_total / 1e3 / steps
         for e in prof.key_averages()
         if e.device_type == DeviceType.CPU and e.key in names}
    if not t:
        return None
    n = {k: sum(launches(e) for e in prof.events()
                if e.name == k and e.device_type == DeviceType.CPU) / steps
         for k in names}
    return {"expert GEMM": t.get("moe.experts", 0.0),
            "routing/dispatch/combine": t.get("moe.ffn", 0.0)
            - t.get("moe.experts", 0.0),
            "launches in expert GEMM": n["moe.experts"],
            "launches in routing/dispatch/combine": n["moe.ffn"]
            - n["moe.experts"]}


# ------------------------------------------- checkpoints and ResNet (8-9)

def ckpt_dir(name: str, need_bytes: int, card: str) -> str:
    """A fresh directory under the checkout's build/ for a checkpoint of
    ``need_bytes``; raises if the filesystem has not that much free, with
    a quarter and 2 GB to spare."""
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_ckpt")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, name)
    shutil.rmtree(path, ignore_errors=True)
    free = shutil.disk_usage(root).free
    want = int(need_bytes * 1.25) + 2 * 10**9
    log(f"[ckpt] {path}: {free / 1e9:.1f} GB free on its filesystem, "
        f"{need_bytes / 1e9:.2f} GB to write, on {card}")
    if free < want:
        raise RuntimeError(f"{root} has {free / 1e9:.1f} GB free; the "
                           f"checkpoint needs {want / 1e9:.1f} GB")
    return path


def tree_tensors(tree):
    """Every tensor of a tree of dicts, lists, tuples and AdamStates, in a
    fixed order."""
    from ray_tpu_torch.train import AdamState

    if isinstance(tree, AdamState):
        tree = {"count": tree.count, "mu": tree.mu, "nu": tree.nu}
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


def phase_serve_checkpoint(cfg, params, card: str, prompts, outs5):
    """Phase 8: phase 5's Llama-3-8B weights (full width and depth) saved
    with Checkpoint.from_pytree, served by LLMDeployment(checkpoint_path=)
    on phase 5's six requests with the launch counters reset: greedy tokens
    identical to phase 5's, flash and paged launches above zero."""
    import shutil

    from ray_tpu_torch.serve.llm import LLMDeployment
    from ray_tpu_torch.train import Checkpoint

    nbytes = tree_bytes(params)
    path = ckpt_dir("llama3_8b", nbytes, card)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with traced() as trace:  # phase 10: the save's and restore's spans
            ck = Checkpoint.from_pytree(params, path)
        save_s = time.perf_counter() - t0
        files = ck.manifest()["files"]
        on_disk = sum(files.values())
        log(f"[serve-ckpt] saved {nbytes / 1e9:.3f} GB of bf16 weights "
            f"({len(files)} files, {on_disk / 1e9:.3f} GB on disk, "
            f"committed {ck.is_committed()}) in {save_s:.2f} s: "
            f"{nbytes / save_s / 1e9:.3f} GB/s save, copies to the host, "
            f"torch.save and fsyncs included, on {card}")
        t0 = time.perf_counter()
        with traced() as restore_trace:
            dep = LLMDeployment(cfg, checkpoint_path=path, device="cuda",
                                **SERVE_ENGINE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check_spans("serve-ckpt", {trace: ["ckpt_save:llama3_8b"],
                                   restore_trace: ["ckpt_restore:llama3_8b"]},
                    card)
        log(f"[serve-ckpt] LLMDeployment(checkpoint_path=) built in "
            f"{load_s:.2f} s: {nbytes / load_s / 1e9:.3f} GB/s load (read, "
            f"copy to the card and the engine's set-up), on {card}")
        same = [torch.equal(a, b) for a, b in
                zip(tree_tensors(dep.engine.params), tree_tensors(params))]
        assert len(same) == 12 and all(same), same
        rng = np.random.RandomState(0)
        launches, _, outs = serve_six(cfg, None, card, "serve-ckpt", rng,
                                      eng=dep.engine, prompts=prompts)
        differ = [i for i, (a, b) in enumerate(zip(outs, outs5)) if a != b]
        log(f"[serve-ckpt] greedy tokens of the six requests against phase "
            f"5's: {6 - len(differ)} of 6 identical (differ: {differ}); "
            f"weights restored bitwise, on {card}")
        assert not differ, (differ, outs, outs5)
        assert launches["flash_fwd"] > 0 and launches["paged_decode"] > 0
        del dep
    finally:
        shutil.rmtree(path, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def phase_resume(card: str):
    """Phase 8b: llama3_8b cut to 2 layers at full width, B = 1, S = 2048,
    through make_mesh() at world size 1: one step, the state saved sharded
    under the mesh, restored into a fresh CompiledTrainStep, two more steps;
    against three steps straight from the same seed."""
    import shutil

    import torch.distributed as dist

    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import Checkpoint, CompiledTrainStep

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=2)
    B, S = 1, 2048
    mesh = make_mesh()
    rs = np.random.RandomState(2)
    toks = [torch.tensor(rs.randint(0, cfg.vocab_size, (B, S + 1)),
                         dtype=torch.int32, device="cuda") for _ in range(3)]

    def fresh():
        step = CompiledTrainStep(cfg, learning_rate=1e-3, mesh=mesh)
        return (step, *step.init(
            torch.Generator(device="cuda").manual_seed(0)))

    with traced() as trace:  # phase 10: every step, the save, the restore
        step, params, opt = fresh()
        straight = [step(params, opt, step.token_sharding().cut(t))[2].item()
                    for t in toks]
        step1, p1, o1 = fresh()
        first = step1(p1, o1, step1.token_sharding().cut(toks[0]))[2].item()
        state = {"params": p1, "opt_state": o1, "step": 1}
        nbytes = tree_bytes(state)
        path = ckpt_dir("resume", nbytes, card)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Checkpoint.from_pytree(state, path, step=1, mesh=mesh,
                                   logical_axes=step1.state_logical_axes())
            save_s = time.perf_counter() - t0
            del state, p1, o1, step1
            torch.cuda.empty_cache()
            step2 = CompiledTrainStep(cfg, learning_rate=1e-3, mesh=mesh)
            train_launches(reset=True)  # the main path: restore and 2 steps
            t0 = time.perf_counter()
            got = Checkpoint(path).as_pytree(
                mesh=mesh, logical_axes=step2.state_logical_axes())
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            resumed = [step2(got["params"], got["opt_state"],
                             step2.token_sharding().cut(t))[2].item()
                       for t in toks[1:]]
            launches = train_launches()
        finally:
            shutil.rmtree(path, ignore_errors=True)
    check_spans("resume", {trace: ["train_step"] * 4 + [
        "ckpt_save:resume", "ckpt_restore:resume"] + ["train_step"] * 2},
        card)
    log(f"[resume] {cfg.num_layers}-layer llama3_8b state ({nbytes / 1e9:.3f}"
        f" GB: bf16 params and moments) saved sharded under {mesh} in "
        f"{save_s:.2f} s ({nbytes / save_s / 1e9:.3f} GB/s), restored onto "
        f"the card in {load_s:.2f} s ({nbytes / load_s / 1e9:.3f} GB/s), on "
        f"{card}")
    losses = [first] + resumed
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, straight))
    worst = 0.0
    for a, b in zip(tree_tensors({"params": got["params"],
                                  "opt_state": got["opt_state"]}),
                    tree_tensors({"params": params, "opt_state": opt})):
        top = b.abs().max().item()
        if top:
            worst = max(worst, (a.float() - b.float()).abs().max().item()
                        / top)
    exact = losses == straight and worst == 0.0
    log(f"[resume] losses 1 step + save/restore + 2 steps {losses} against 3"
        f" steps straight {straight}: {'identical' if exact else 'differ'}"
        f"; worst loss relative difference {loss_rel:.3e}, worst weight or "
        f"moment max|d| / max|ref| {worst:.3e} (tol 1e-6 where not "
        f"identical); launches in the restore and 2 steps {launches}; on "
        f"{card}")
    assert loss_rel <= 1e-6 and worst <= 1e-6, (loss_rel, worst)
    assert got["step"] == 1 and got["opt_state"].count == 3
    assert launches["flash_bwd_dq"] > 0, launches
    assert launches["flash_bwd_dkv_per_head"] > 0, launches
    del got, params, opt, step, step2
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return launches


def phase_resnet(card: str):
    """Phase 9: ResNet-18, card against CPU in float32 (TF32 off), then
    trained in bf16 at the CIFAR-10 geometry, committed, and scored by
    TorchPredictor on the card."""
    import shutil

    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.train import AdamState, AdamW, Checkpoint
    from ray_tpu_torch.train import TorchPredictor

    def moved(tree, device):  # a copy of a tree of dicts and AdamStates
        if isinstance(tree, AdamState):
            return AdamState(tree.count, moved(tree.mu, device),
                             moved(tree.nu, device))
        if isinstance(tree, dict):
            return {k: moved(v, device) for k, v in tree.items()}
        if torch.is_tensor(tree):
            return tree.to(device, copy=True)
        return tree

    class Recorded:  # an optimizer keeping CPU copies of what it is given
        def __init__(self, tx):
            self.tx = tx

        def update(self, params, grads, opt):
            self.given = (moved(params, "cpu"), moved(grads, "cpu"),
                          moved(opt, "cpu"))
            return self.tx.update(params, grads, opt)

    def worst_of(got, want) -> float:  # max over leaves of max|d| / max|ref|
        out = 0.0
        for a, b in zip(tree_tensors(got), tree_tensors(want), strict=True):
            d = (a.detach().cpu() - b).abs().max().item()
            top = b.abs().max().item()
            out = max(out, d / top if top else (0.0 if d == 0 else np.inf))
        return out

    # 1. Two train_steps at B = 8 in float32 (TF32 off) on the card, its
    # state carried from the first step into the second. Before each step
    # the CPU takes a copy of the card's state and steps from it, so that
    # each step is held from the same weights: train-mode logits, new batch
    # statistics and the loss within 1e-3 of each tensor's max|ref|, and
    # the card's fused AdamW (params and both moments) within 1e-5 of the
    # CPU's AdamW run on the card's own gradients and state (and float32
    # betas, below). Every gradient (cuDNN's channels-last backward) is
    # held within 1e-3 in the first step, from the drawn weights; in the
    # second it is printed: one Adam(1e-2) step at B = 8 more than triples
    # the loss, and there the float32 gradient moves by more than 1e-3 of
    # its max under another order of summation (cuDNN's, or PyTorch's own
    # CUDA convolutions, against the CPU's). The two devices' trajectories are not held together:
    # Adam's first step is lr * sign(g), so a rounding difference flips the
    # elements whose gradient is near 0. The second norms' zero scales are
    # drawn nonzero, so every convolution reaches the output.
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = resnet.resnet18(num_classes=10, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    adam = AdamW(1e-2, weight_decay=0.0)
    # The CUDA fused AdamW rounds the betas to float32 (1 - b2 is then off
    # by 1.29e-5 of itself); the CPU's update it is held to takes the same.
    adam32 = AdamW(1e-2, b1=float(np.float32(0.9)),
                   b2=float(np.float32(0.999)), weight_decay=0.0)
    cpu = resnet.create_train_state(model, gen, (8, 32, 32, 3), adam, "cpu")
    for name, block, _ch in model.blocks():
        cpu["params"][name]["norm2"]["scale"] = 1 + 0.1 * torch.randn(
            block.filters, generator=gen)
    card_state = moved(cpu, "cuda")
    rs = np.random.RandomState(9)
    steps = []
    for i in range(2):
        x = torch.from_numpy(rs.randn(8, 32, 32, 3).astype(np.float32))
        y = torch.from_numpy(rs.randint(0, 10, (8,)))
        ref = moved(card_state, "cpu")
        with torch.no_grad():
            want = model.apply(ref, x)[0]
            got = model.apply(card_state, x.cuda())[0]
        on_cpu, on_card = Recorded(adam), Recorded(adam)
        loss_c = resnet.train_step(model, ref, x, y, on_cpu).item()
        loss_g = resnet.train_step(model, card_state, x.cuda(), y.cuda(),
                                   on_card).item()
        params, grads, opt = on_card.given
        adam32.update(params, grads, opt)  # the CPU's, on the card's grads
        steps.append({
            "loss_cpu": loss_c,
            "logits": worst_of(got, want),
            "loss": abs(loss_g - loss_c) / abs(loss_c),
            "batch_stats": worst_of(card_state["batch_stats"],
                                    ref["batch_stats"]),
            "grads": worst_of(grads, on_cpu.given[1]),
            "adamw_params": worst_of(card_state["params"], params),
            "adamw_mu": worst_of(card_state["opt_state"].mu, opt.mu),
            "adamw_nu": worst_of(card_state["opt_state"].nu, opt.nu)})
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    for i, d in enumerate(steps):
        loss_c = d.pop("loss_cpu")
        log(f"[resnet] resnet18 float32 B=8, train_step {i + 1} of 2 on the "
            f"card, state carried, against the CPU from the card's weights "
            f"(TF32 off; CPU loss {loss_c:.6f}): max|d| / max|ref| {d} (tol "
            f"1e-3, grads "
            f"{'1e-3' if i == 0 else 'printed only'}; adamw_* 1e-5), on "
            f"{card}")
        held = ["logits", "loss", "batch_stats"] + (["grads"] if i == 0
                                                     else [])
        assert all(d[k] <= 1e-3 for k in held), (i, d)
        assert all(d[k] <= 1e-5 for k in d if k.startswith("adamw")), (i, d)
    assert card_state["step"] == 2 and card_state["opt_state"].count == 2
    del cpu, card_state, ref

    # 2. resnet18() in bf16 at the CIFAR-10 geometry, synthetic data from a
    # seed, 8 steps of Adam(1e-2): the loss must fall.
    model = resnet.resnet18()
    B = 128
    state = resnet.create_train_state(
        model, torch.Generator(device="cuda").manual_seed(0),
        (B, 32, 32, 3), adam, "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B, 32, 32, 3, generator=g, device="cuda")
    y = torch.randint(0, 10, (B,), generator=g, device="cuda")
    losses, times = [], []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(resnet.train_step(model, state, x, y, adam).item())
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times[2:])) * 1e3
    log(f"[resnet] resnet18 bf16 B={B} 32x32x3, 8 steps of Adam(1e-2): "
        f"losses {[round(v, 4) for v in losses]}; {ms:.2f} ms/step (median "
        f"of steps 3-8, synchronised; all "
        f"{[round(t * 1e3, 1) for t in times]}), {B / ms * 1e3:.0f} "
        f"images/s, on {card}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        resnet.train_step(model, state, x, y, adam)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _report(f"resnet18 train step B={B}", wall, _device_kernels(prof, 1),
            kinds=RESNET_KINDS, top=8)
    _host_report(prof)

    # 3. Commit {"params", "batch_stats"}, restore it with TorchPredictor on
    # the card: its predictions equal the model's eval logits bitwise.
    variables = {"params": state["params"],
                 "batch_stats": state["batch_stats"]}
    path = ckpt_dir("resnet18", tree_bytes(variables), card)
    try:
        ck = Checkpoint.from_pytree(variables, path, step=state["step"])
        pred = TorchPredictor.from_checkpoint(
            ck, apply_fn=lambda v, x: model.apply(v, x, train=False))
        batch = {"x": np.random.RandomState(4).randn(64, 32, 32, 3).astype(
            np.float32)}
        got = pred.predict(batch)["predictions"]
        saved_step = ck.step
    finally:
        shutil.rmtree(path, ignore_errors=True)
    with torch.inference_mode():
        want = model.apply(variables, torch.from_numpy(batch["x"]).cuda(),
                           train=False).cpu().numpy()
    same = np.array_equal(got, want)
    log(f"[resnet] TorchPredictor from the committed checkpoint (step "
        f"{saved_step}) on the card: predictions [64, 10] "
        f"{'equal' if same else 'differ from'} the eval logits bitwise "
        f"(max|d| {np.abs(got - want).max():.3e}), on {card}")
    assert same and got.shape == (64, 10)
    del state, variables, pred
    torch.cuda.empty_cache()


def _traced_ranges(path: str, prefix: str):
    """From a profiler's chrome trace: {CPU range name: the GPU kernels,
    copies and memsets launched inside it, as (name, stream, start, end,
    correlation) in launch order}, for the ranges whose name starts with
    ``prefix``, in µs. A launch belongs to a range when its runtime call
    falls inside the range's time, on any thread (autograd launches the
    backward from its own)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    gpu, ranges, launches = {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        end = e["ts"] + e.get("dur", 0)
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and \
                "correlation" in args:
            gpu[args["correlation"]] = (e["name"], args.get("stream"),
                                        e["ts"], end, args["correlation"])
        elif cat == "user_annotation" and e["name"].startswith(prefix):
            ranges[e["name"]] = (e["ts"], end)
        elif cat in ("cuda_runtime", "cuda_driver") and \
                "correlation" in args:
            launches.append((e["ts"], args["correlation"]))
    return {name: [gpu[c] for t, c in sorted(launches, key=lambda x: x[1])
                   if t0 <= t <= t1 and c in gpu]
            for name, (t0, t1) in ranges.items()}


def phase_ingest(card: str):
    """Phase 11: the ingest (``data.iter_device_batches``) at phase 9's
    ResNet-18 geometry: a seeded numpy source (float32 images B=128,
    32x32x3, int64 labels) ingested bitwise, in order, with JAX's dtypes;
    the bf16 train step fed by the ingest against the same step on batches
    already on the card, in turns; the host-to-device rate of a 38.5 MB
    uint8 batch (B=256, 224x224x3), pinned against pageable; the ingest's
    pinned ring against a plain one-ahead copy from pageable memory
    (``pageable_batches``), in turns on both; and a profiler trace of
    ingested steps: each batch's copy on the side stream, against the
    steps' kernels."""
    from concurrent.futures import ThreadPoolExecutor

    from torch.profiler import ProfilerActivity, profile, record_function

    from ray_tpu_torch.data import ingest, iter_device_batches
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.train import AdamW

    B, n = 128, 32
    rs = np.random.RandomState(11)
    source = [{"x": rs.randn(B, 32, 32, 3).astype(np.float32),
               "y": rs.randint(0, 10, (B,))} for _ in range(n)]
    # 1. Values: every batch read back from the card equals its source.
    got = [{k: t.cpu() for k, t in b.items()}
           for b in iter_device_batches(source)]
    same = all(torch.equal(g["x"], torch.from_numpy(w["x"]))
               and torch.equal(g["y"], torch.from_numpy(
                   w["y"].astype(np.int32)))
               for g, w in zip(got, source))
    log(f"[ingest] {len(got)} of {n} batches (x float32 [{B}, 32, 32, 3], y "
        f"int64 -> {got[0]['y'].dtype}) read back from the card: "
        f"{'bitwise equal to' if same else 'DIFFER from'} their source, in "
        f"order; on {card}")
    assert same and len(got) == n and got[0]["y"].dtype == torch.int32

    def pageable_batches(batches):
        """The plain alternative to the ingest's pinned ring: each batch
        copied from its own pageable memory on a side stream, one batch
        ahead, handed over with the same event wait and record_stream."""
        side = torch.cuda.Stream()

        def put(batch):
            with torch.cuda.stream(side):
                out = {key: torch.from_numpy(np.ascontiguousarray(
                    v, dtype=ingest.canonical_dtype(v.dtype))).to(
                        "cuda", non_blocking=True)
                    for key, v in batch.items()}
                event = torch.cuda.Event()
                event.record(side)
            return out, event

        def take(pending):
            out, event = pending
            consumer = torch.cuda.current_stream()
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
            return out

        return ingest._one_ahead(batches, put, take)

    def host_timed(batches, acc):
        """``batches``, adding the host seconds of each next() to acc."""
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            if b is None:
                return
            acc.append(time.perf_counter() - t0)
            yield b

    got = [{k: t.cpu() for k, t in b.items()}
           for b in pageable_batches(source)]
    assert all(torch.equal(g["x"], torch.from_numpy(w["x"]))
               and torch.equal(g["y"], torch.from_numpy(
                   w["y"].astype(np.int32))) for g, w in zip(got, source))
    del got

    # 2. The train step fed by the ingest, by pageable_batches and on
    # pre-staged batches: three rounds of (ingest, staged, pageable,
    # pageable, staged, ingest), n steps a window; the host's seconds
    # inside each next() of the two feeds.
    model = resnet.resnet18()
    adam = AdamW(1e-2, weight_decay=0.0)
    state = resnet.create_train_state(
        model, torch.Generator(device="cuda").manual_seed(0),
        (B, 32, 32, 3), adam, "cuda")
    staged = [{"x": torch.from_numpy(b["x"]).cuda(),
               "y": torch.from_numpy(b["y"].astype(np.int32)).cuda()}
              for b in source]

    feeds = {"ingest": lambda: iter_device_batches(source),
             "pageable": lambda: pageable_batches(source),
             "staged": lambda: staged}
    host = {"ingest": [], "pageable": []}

    def window(which):
        batches = feeds[which]()
        if which in host:
            batches = host_timed(batches, host[which])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            resnet.train_step(model, state, b["x"], b["y"], adam)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    window("ingest")  # warm-ups: plans, pinned buffers
    window("pageable")
    host = {"ingest": [], "pageable": []}
    ms = {k: [] for k in feeds}
    for which in ("ingest", "staged", "pageable",
                  "pageable", "staged", "ingest") * 3:
        ms[which].append(window(which))
    fed, page, pre = (float(np.median(ms[k]))
                      for k in ("ingest", "pageable", "staged"))
    log(f"[ingest] resnet18 bf16 train step B={B}, {n}-step windows, 3 "
        f"rounds of (ingest, staged, pageable, pageable, staged, ingest): "
        f"fed by the ingest {[round(v, 2) for v in ms['ingest']]} ms/step, "
        f"by pageable_batches {[round(v, 2) for v in ms['pageable']]}, on "
        f"batches already on the card {[round(v, 2) for v in ms['staged']]}"
        f"; medians {fed:.2f} / {page:.2f} / {pre:.2f}: the ingest "
        f"{fed / pre:.4f}x pre-staged "
        f"({'within' if fed / pre <= 1.05 else 'NOT within'} 5%), "
        f"pageable {page / pre:.4f}x; on {card}")
    log(f"[ingest] host µs inside next() a step (median, mean over "
        f"{len(host['ingest'])} steps): the ingest's pinned ring "
        f"{np.median(host['ingest']) * 1e6:.1f}, "
        f"{np.mean(host['ingest']) * 1e6:.1f}; pageable_batches "
        f"{np.median(host['pageable']) * 1e6:.1f}, "
        f"{np.mean(host['pageable']) * 1e6:.1f}; on {card}")

    # 3. Host-to-device rates for one 38.5 MB uint8 batch, each after a
    # warm-up (the ingest's: its pinned buffers, which the host allocator
    # then keeps).
    big = rs.randint(0, 256, (256, 224, 224, 3)).astype(np.uint8)
    nbytes, k = big.nbytes, 8

    def ingest_s():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in iter_device_batches([{"x": big}] * k):
            assert b["x"].dtype == torch.uint8
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k

    ingest_s()
    through = ingest_s()

    # The pinned ring (with its threaded fill, and filled by one thread)
    # against pageable_batches, host seconds a batch, in turns.
    def feed_s(which):
        one = which == "ring, one thread"
        keep, ingest.FILL_BYTES = ingest.FILL_BYTES, (
            1 << 62 if one else ingest.FILL_BYTES)
        try:
            feed = (pageable_batches if which == "pageable"
                    else iter_device_batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in feed([{"x": big}] * k):
                assert b["x"].dtype == torch.uint8
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / k
        finally:
            ingest.FILL_BYTES = keep

    turns = ("ring", "ring, one thread", "pageable")
    for which in turns:
        feed_s(which)  # warm-up
    rate = {w: [] for w in turns}
    for which in (turns + turns[::-1]) * 2:
        rate[which].append(nbytes / feed_s(which) / 1e9)
    log(f"[ingest] host to device, {nbytes / 1e6:.1f} MB uint8 batch, {k} "
        f"batches a turn, 2 rounds of (ring, ring one thread, pageable, "
        f"pageable, ring one thread, ring), GB/s of host time: " + "; ".join(
            f"{w} {[round(v, 2) for v in rate[w]]} (median "
            f"{np.median(rate[w]):.2f})" for w in turns) + f"; on {card}")
    pinned = torch.from_numpy(big).pin_memory()
    pageable = torch.from_numpy(big)

    def h2d_s(src, non_blocking):
        src.to("cuda", non_blocking=non_blocking)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            src.to("cuda", non_blocking=non_blocking)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / k / 1e3

    pin_s, page_s = h2d_s(pinned, True), h2d_s(pageable, False)
    fill_s = {}
    with ThreadPoolExecutor(ingest.FILL_THREADS) as pool:
        for threads in (1, ingest.FILL_THREADS):
            t0 = time.perf_counter()
            for _ in range(k):
                if threads == 1:
                    np.copyto(pinned.numpy(), big)
                else:
                    ingest._fill(pinned.numpy(), big, pool)
            fill_s[threads] = (time.perf_counter() - t0) / k
    log(f"[ingest] host to device, {nbytes / 1e6:.1f} MB uint8 batch "
        f"(256 x 224 x 224 x 3), {k} batches: through the ingest (a host "
        f"copy into a pinned buffer, then the copy to the card, one batch "
        f"ahead) {nbytes / through / 1e9:.2f} GB/s; the host copy alone "
        + ", ".join(f"{nbytes / v / 1e9:.2f} GB/s on {n} thread(s)"
                    for n, v in fill_s.items())
        + f"; a copy to the card alone from pinned memory "
        f"{nbytes / pin_s / 1e9:.2f} GB/s, from pageable memory "
        f"{nbytes / page_s / 1e9:.2f} GB/s (CUDA events); on {card}")
    del pinned, pageable, big

    # 4. A profiler trace of ingested steps: where each batch's copy runs.
    # next(it) queues batch i + 1 and hands over batch i; step i then runs
    # on it. The trace loses the GPU's first records (the copies of
    # batches 0 and 1, queued by the first next), so batches 2 on are read.
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    path = os.path.join(root, "smoke_ingest_trace.json")
    steps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        it = iter_device_batches(source[:steps])
        for i in range(steps):
            with record_function(f"ingest.next{i}"):
                b = next(it)
            with record_function(f"ingest.step{i}"):
                resnet.train_step(model, state, b["x"], b["y"], adam)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    traced = _traced_ranges(path, "ingest.")
    kernels = [traced[f"ingest.step{i}"] for i in range(steps)]
    spans = [(min(g[2] for g in ks), max(g[3] for g in ks))
             for ks in kernels]
    compute = {g[1] for ks in kernels for g in ks}
    copies = {i + 1: [g for g in traced[f"ingest.next{i}"]
                      if "HtoD" in g[0]] for i in range(1, steps - 1)}
    side = {g[1] for c in copies.values() for g in c}
    t_0 = spans[0][0]
    log(f"[ingest] profiler trace of {steps} ingested steps: the copies "
        f"(x, y) of batches {sorted(copies)} on stream(s) {sorted(side)}, "
        f"the steps' kernels on stream(s) {sorted(compute)}; µs from step "
        f"0's first kernel; on {card}")
    for k, c in copies.items():
        a, z = min(g[2] for g in c), max(g[3] for g in c)
        over = [j for j, (k0, k1) in enumerate(spans) if a < k1 and z > k0]
        idle = max([k1 for k0, k1 in spans if k1 <= a], default=t_0)
        log(f"[ingest]   batch {k} copy [{a - t_0:.1f}, {z - t_0:.1f}] "
            f"({sum(g[3] - g[2] for g in c):.1f} µs of copies), queued "
            f"after step {k - 2}'s launches: overlapping the kernels of "
            f"step(s) {over}, {a - idle:.1f} µs after the last kernel "
            f"before it ended; step {k}'s kernels [{spans[k][0] - t_0:.1f},"
            f" {spans[k][1] - t_0:.1f}]")
        assert len(c) == 2 and z <= spans[k][0] + 5, (k, c, spans[k])
    assert not side & compute, (side, compute)
    del state, staged
    torch.cuda.empty_cache()


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "sm90")
SERVE_KINDS = (("flash_fwd", ("flash_fwd",)),
               ("paged_decode", ("paged_decode",)), ("gemm", GEMM_NAMES))
TRAIN_KINDS = (("flash_fwd", ("flash_fwd",)), ("dq", ("flash_bwd_dq",)),
               ("dkv", ("flash_bwd_dkv",)), ("optimizer", ("adam",)),
               ("gemm", GEMM_NAMES))
RESNET_KINDS = (("optimizer", ("adam",)),
                ("conv/gemm", GEMM_NAMES + ("conv", "cudnn", "dgrad",
                                            "wgrad", "fprop")))


def _report(what: str, wall_ms: float, rows, kinds=SERVE_KINDS,
            top: int = 6, moe=None) -> None:
    busy = sum(r[1] for r in rows)
    groups = {label: 0.0 for label, _ in kinds}
    groups["other"] = 0.0
    for name, ms, _n in rows:
        low = name.lower()
        label = next((lb for lb, keys in kinds
                      if any(k in low for k in keys)), "other")
        groups[label] += ms
    log(f"[breakdown] {what}: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}; "
        f"device ms by kind " + ", ".join(
            f"{k} {v:.3f}" for k, v in groups.items()) +
        f"; {sum(r[2] for r in rows):.0f} kernel launches")
    if moe:
        log(f"[breakdown] {what}: MoE device ms by kind (inside the kinds "
            f"above): " + ", ".join(f"{k} {v:.3f}" for k, v in moe.items()
                                    if not k.startswith("launches"))
            + "; kernel launches " + ", ".join(
                f"{k[12:]} {v:.0f}" for k, v in moe.items()
                if k.startswith("launches")))
    for name, ms, n in rows[:top]:
        log(f"[breakdown]   {ms:.3f} ms x{n:.0f} {name[:90]}")


def phase_breakdown(cfg, params, card: str):
    """Where a decode step and a prefill spend their time at full width:
    host wall time (synchronised) against device busy time from
    torch.profiler, and the decode step with the paged kernel against the
    same step through the gather path, timed in turns."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.generation import (
        PagedKVCache, paged_decode, paged_prefill, sample_logits)

    B, page, pmax = 4, 16, 32
    dev = "cuda"
    cache = PagedKVCache.create(cfg, B, B * pmax, page, pmax, dev)
    cache = cache._replace(
        page_table=torch.arange(B * pmax, dtype=torch.int32,
                                device=dev).reshape(B, pmax),
        lengths=torch.tensor([300, 200, 130, 100], dtype=torch.int32,
                             device=dev))
    cache.k.normal_()
    cache.v.normal_()
    toks = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    gather_cfg = dataclasses.replace(cfg, use_flash=False)
    ptoks = torch.zeros(1, 512, dtype=torch.int32, device=dev)
    pages = torch.arange(512 // page, device=dev)

    def decode(c):  # one engine step: forward, greedy pick, copy to host
        logits, _ = paged_decode(params, toks, cache, c, active=active)
        sample_logits(logits).cpu()

    def prefill():  # one admission at bucket 512: a flash launch a layer
        logits, _ = paged_prefill(params, ptoks, 300, cache, cfg, 0, pages)
        sample_logits(logits).cpu()

    def wall_ms(fn, n=10):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        turns = [wall_ms(lambda: decode(cfg)),
                 wall_ms(lambda: decode(gather_cfg)),
                 wall_ms(lambda: decode(gather_cfg)),
                 wall_ms(lambda: decode(cfg))]
        kernel_ms = (turns[0] + turns[3]) / 2
        log(f"[breakdown] decode step B=4 (lengths 300/200/130/100) on "
            f"{card}: paged kernel {turns[0]:.2f}/{turns[3]:.2f} ms, gather "
            f"path {turns[1]:.2f}/{turns[2]:.2f} ms (kernel, gather, gather,"
            f" kernel)")
        with profile(activities=acts) as prof:
            for _ in range(5):
                decode(cfg)
        _report("decode step B=4", kernel_ms, _device_kernels(prof, 5),
                moe=_moe_ranges(prof, 5))
        prefill_ms = wall_ms(prefill, n=5)
        with profile(activities=acts) as prof:
            for _ in range(3):
                prefill()
        _report("prefill bucket 512", prefill_ms, _device_kernels(prof, 3),
                moe=_moe_ranges(prof, 3))


# ------------------------------------------------ RLlib's learners (12)

class Box:
    """A gymnasium-style Box space: ``low``, ``high`` and ``shape``."""

    def __init__(self, low, high, shape):
        self.low = np.broadcast_to(np.float32(low), shape).copy()
        self.high = np.broadcast_to(np.float32(high), shape).copy()
        self.shape = shape


class Discrete:
    """A gymnasium-style Discrete space of ``n`` actions."""

    def __init__(self, n):
        self.n = n
        self.shape = ()


class CartPole:
    """CartPole-v1 in numpy (the card's machine has no gymnasium):
    gymnasium's classic_control/cartpole.py equations (Euler steps of
    0.02 s, force 10, pole half-length 0.5, failure at 12 degrees or
    2.4), its reset draw (uniform in +-0.05 from a PCG64 generator that
    ``reset(seed=)`` seeds), its spaces and the TimeLimit wrapper's
    truncation at 500 steps."""

    obs_dim, num_actions = 4, 2
    gravity, masscart, masspole, length = 9.8, 1.0, 0.1, 0.5
    total_mass = masspole + masscart
    polemass_length = masspole * length
    force_mag, tau, max_steps = 10.0, 0.02, 500
    theta_threshold = 12 * 2 * np.pi / 360
    x_threshold = 2.4
    _high = np.array([x_threshold * 2, np.finfo(np.float32).max,
                      theta_threshold * 2, np.finfo(np.float32).max],
                     dtype=np.float32)
    observation_space = Box(-_high, _high, (4,))
    action_space = Discrete(2)

    def __init__(self):
        self.np_random = None
        self.state = None
        self.steps = 0

    def reset(self, seed=None):
        if seed is not None or self.np_random is None:
            self.np_random = np.random.Generator(
                np.random.PCG64(np.random.SeedSequence(seed)))
        self.state = self.np_random.uniform(low=-0.05, high=0.05, size=(4,))
        self.steps = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold
                          or theta > self.theta_threshold)
        self.steps += 1
        return (np.array(self.state, dtype=np.float32), 1.0, terminated,
                self.steps >= self.max_steps, {})


RL_LOW, RL_HIGH = np.float32([-2.0]), np.float32([2.0])  # Pendulum's Box


def rl_batch(kind: str, n: int, rng):
    """A seeded numpy batch of ``n`` rows in the layout ``kind`` takes:
    CartPole's 4 observations and 2 actions for the discrete learners, 3
    observations and 1 action in [-2, 2] for the continuous ones."""
    from ray_tpu_torch.rllib.dqn import DISCOUNT
    from ray_tpu_torch.rllib.sample_batch import SampleBatch

    f32 = np.float32
    if kind in ("ddpg", "td3", "sac"):
        return SampleBatch(
            obs=rng.randn(n, 3).astype(f32),
            actions=rng.uniform(-2, 2, (n, 1)).astype(f32),
            rewards=rng.randn(n).astype(f32), dones=rng.rand(n) < 0.1,
            next_obs=rng.randn(n, 3).astype(f32))
    obs = rng.randn(n, 4).astype(f32)
    actions = rng.randint(0, 2, n).astype(np.int32)
    if kind.startswith("dqn"):
        b = SampleBatch(obs=obs, actions=actions,
                        rewards=rng.randn(n).astype(f32),
                        next_obs=rng.randn(n, 4).astype(f32))
        b[DISCOUNT] = (0.99 * (rng.rand(n) > 0.1)).astype(f32)
        if kind == "dqn_dueling":  # a prioritized buffer's weights
            b["weights"] = rng.uniform(0.2, 1.0, n).astype(f32)
        return b
    if kind == "impala":  # one time-major fragment and its bootstrap row
        return SampleBatch(obs=obs, actions=actions,
                           action_logp=np.log(rng.uniform(0.2, 0.8, n)
                                              ).astype(f32),
                           rewards=rng.randn(n).astype(f32),
                           dones=rng.rand(n) < 0.05,
                           bootstrap_obs=rng.randn(4).astype(f32))
    b = SampleBatch(obs=obs, actions=actions,
                    advantages=rng.randn(n).astype(f32),
                    returns=rng.randn(n).astype(f32))
    if kind.startswith("ppo"):  # update_epochs' keys
        return {"obs": obs, "actions": actions,
                "old_logp": np.log(rng.uniform(0.2, 0.8, n)).astype(f32),
                "adv": b["advantages"], "returns": b["returns"]}
    return b


def rl_learner(kind: str, device):
    """One learner of each family at the JAX defaults' geometry (hidden
    64), with ``step(batch, i)`` running its update the way its algorithm
    does and giving back its stats (tensors or floats)."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.policy import (
        DeterministicPolicy, DuelingQPolicy, QPolicy,
        SquashedGaussianPolicy)

    mlp = rllib.MLPPolicy(4, 2, 64, 0)
    if kind.startswith("ppo"):
        c = rllib.PPOConfig()
        lrn = rllib.PPOLearner(mlp, c.lr, c.clip_param, c.vf_loss_coeff,
                               c.entropy_coeff, device=device,
                               is_ratio_clip=2.0 if kind == "ppo_is_clip"
                               else None)
        return lrn, lambda b, i: lrn.update_device(b)
    if kind == "a2c":
        c = rllib.A2CConfig()
        lrn = rllib.A2CLearner(mlp, c.lr, c.vf_loss_coeff, c.entropy_coeff,
                               device=device)
        return lrn, lambda b, i: lrn.update_minibatch(b)
    if kind == "pg":
        lrn = rllib.PGLearner(mlp, rllib.PGConfig().lr, device=device)
        return lrn, lambda b, i: lrn.update_minibatch(b)
    if kind == "impala":
        c = rllib.IMPALAConfig()
        lrn = rllib.IMPALALearner(mlp, c.lr, c.gamma, c.rho_clip, c.c_clip,
                                  c.vf_loss_coeff, c.entropy_coeff,
                                  device=device)
        return lrn, lambda b, i: lrn.update(b)
    if kind.startswith("dqn"):
        pol = (DuelingQPolicy if kind == "dqn_dueling" else QPolicy)(
            4, 2, 64, 0)
        lrn = rllib.DQNLearner(pol, rllib.DQNConfig().lr, True,
                               device=device)

        def step(b, i):
            out = lrn.update(b)
            if i == 0:
                lrn.sync_target()
            return {"loss": out["loss"],
                    "td_abs_max": float(np.abs(out["td_error"]).max())}
        return lrn, step
    if kind == "sac":
        lrn = rllib.SACLearner(
            SquashedGaussianPolicy(3, 1, RL_LOW, RL_HIGH, 64, 0),
            rllib.SACConfig(), 3, 1, RL_LOW, RL_HIGH, device=device)
        return lrn, lambda b, i: lrn.update(b)
    cls, cfg = ((rllib.DDPGLearner, rllib.DDPGConfig()) if kind == "ddpg"
                else (rllib.TD3Learner, rllib.TD3Config()))
    lrn = cls(DeterministicPolicy(3, 1, RL_LOW, RL_HIGH, 64, 0), cfg, 3, 1,
              RL_LOW, RL_HIGH, device=device)
    if kind == "ddpg":
        return lrn, lambda b, i: lrn.learn_on_batch(b)
    return lrn, lambda b, i: lrn.learn_on_batch(
        b, do_actor=i % cfg.policy_delay == 0)


RL_KINDS = ("ppo", "ppo_is_clip", "a2c", "pg", "impala", "dqn_double",
            "dqn_dueling", "ddpg", "td3", "sac")


def rl_state(lrn):
    """{path: numpy array} of every tensor a learner keeps: its params and
    targets."""
    from ray_tpu_torch.rllib.core import tree_to_numpy

    def flat(tree, prefix):
        if isinstance(tree, dict):
            tree = {str(k): v for k, v in tree.items()}
        elif isinstance(tree, (list, tuple)):
            tree = {str(i): v for i, v in enumerate(tree)}
        else:
            return {prefix: tree}
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}.{key}").items()}

    # QMIX keeps its hard-synced target tree apart from the polyak ones.
    target = getattr(lrn, "_target_full", getattr(lrn, "_target", {}))
    return flat(tree_to_numpy({"params": lrn._params, "target": target}),
                "")


def phase_rllib_parity(card: str):
    """Phase 12a: each learner's three updates on the card against the
    same three on the CPU from the same weights, float32 with TF32 off:
    every stat of every update within 1e-5 of the CPU's (relative, with
    1e-6 absolute for a stat near 0) and every weight and target within
    1e-4 after the third."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for kind in RL_KINDS:
            n = 200 if kind == "impala" else 128
            batches = [rl_batch(kind, n, np.random.RandomState(i))
                       for i in range(3)]
            runs = {}
            for dev in ("cuda", "cpu"):
                lrn, step = rl_learner(kind, dev)
                runs[dev] = ([{k: float(v) for k, v in step(b, i).items()}
                              for i, b in enumerate(batches)], rl_state(lrn))
            (gs, gw), (cs, cw) = runs["cuda"], runs["cpu"]
            share = {}
            for g, c in zip(gs, cs):
                assert g.keys() == c.keys(), (kind, g, c)
                for k in c:
                    share[k] = max(share.get(k, 0.0), abs(g[k] - c[k])
                                   / (1e-5 * abs(c[k]) + 1e-6))
            w_err = max(float(np.abs(gw[k] - cw[k]).max()) for k in cw)
            log(f"[rllib] {kind}: 3 updates card vs CPU; each stat's worst "
                f"|card - CPU| as a share of its bound 1e-5 |CPU| + 1e-6: "
                + ", ".join(f"{k} {v:.3f}" for k, v in share.items())
                + f"; worst weight error {w_err:.2e} (bound 1e-4) over "
                f"{len(cw)} tensors; on {card}")
            assert max(share.values()) <= 1.0, (kind, gs, cs)
            assert w_err <= 1e-4, (kind, w_err)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median wall milliseconds of one call that ends synchronised."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


RL_PPO_12B = {}  # phase 12b's sampled actions and sampling ms, by iteration


def phase_rllib_ppo(card: str):
    """Phase 12b: PPO learns CartPole-v1 with the learner on the card, fed
    by two of the port's EnvRunners (seeds 0 and 1) with
    tests/test_rllib.py's PPOConfig; then one update_device's ms, the
    sampling ms of an iteration, and a profiled update_epochs."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.rllib import (
        EnvRunner, MLPPolicy, PPOConfig, PPOLearner, SampleBatch)
    from ray_tpu_torch.rllib.sample_batch import (
        ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS)

    c = (PPOConfig()
         .env_runners(num_env_runners=2, rollout_fragment_length=256)
         .training(lr=3e-3, train_batch_size=512, minibatch_size=128,
                   num_epochs=6)
         .debugging(seed=0))

    def policy():
        return MLPPolicy(CartPole.obs_dim, CartPole.num_actions,
                         c.hidden_size, c.seed)

    runners = [EnvRunner(CartPole, policy, seed=c.seed + i,
                         rollout_fragment_length=c.rollout_fragment_length,
                         gamma=c.gamma, lam=c.lambda_)
               for i in range(c.num_env_runners)]
    learner = PPOLearner(policy(), c.lr, c.clip_param, c.vf_loss_coeff,
                         c.entropy_coeff)  # no device given: the card
    assert learner.device.type == "cuda", learner.device
    rng = np.random.RandomState(c.seed)
    first, best, rewards, sample_ms, learn_ms = None, 0.0, [], [], []
    actions = []
    for _ in range(25):
        t0 = time.perf_counter()
        batches = []
        while sum(b.count for b in batches) < c.train_batch_size:
            batches.extend(r.sample() for r in runners)
        batch = SampleBatch.concat(batches)
        t1 = time.perf_counter()
        actions.append(batch[ACTIONS].copy())
        learner.update_epochs(batch, epochs=c.num_epochs,
                              minibatch_size=c.minibatch_size, rng=rng)
        weights = learner.get_weights()
        for r in runners:
            r.set_weights(weights)
        t2 = time.perf_counter()
        sample_ms.append((t1 - t0) * 1e3)
        learn_ms.append((t2 - t1) * 1e3)
        stats = [r.episode_stats() for r in runners]
        means = [s["episode_reward_mean"] for s in stats
                 if s["episodes_total"] > 0]
        mean = float(np.mean(means)) if means else 0.0
        rewards.append(round(mean, 1))
        if first is None and sum(s["episodes_total"] for s in stats) > 0:
            first = mean
        best = max(best, mean)
        if best > 80:
            break
    log(f"[rllib] PPO on CartPole-v1 (numpy copy), 2 EnvRunners x 256 "
        f"steps, 6 epochs x 4 minibatches of 128, lr 3e-3: mean episode "
        f"reward by iteration {rewards}; first {first}, best {best:.1f} "
        f"(need > 60 and > first + 30); an iteration's sampling "
        f"{np.median(sample_ms):.1f} ms, update_epochs + get_weights "
        f"{np.median(learn_ms):.1f} ms (medians); on {card}")
    assert first is not None and best > 60 and best > first + 30, (
        first, best, rewards)
    RL_PPO_12B.update(actions=actions, sample_ms=sample_ms)

    mb = {"obs": batch[OBS][:128],
          "actions": np.asarray(batch[ACTIONS][:128], np.int32),
          "old_logp": batch[LOGPS][:128], "adv": batch[ADVANTAGES][:128],
          "returns": batch[RETURNS][:128]}
    upd = median_ms(lambda: learner.update_device(mb), reps=50)
    # The minibatch loop queues its updates without waiting for the card:
    # any synchronising CUDA call in it raises here.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(8):
            stats = learner.update_device(mb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(v.is_cuda for v in stats.values()), stats

    def epochs():
        learner.update_epochs(batch, epochs=c.num_epochs,
                              minibatch_size=c.minibatch_size, rng=rng)

    wall = median_ms(epochs, reps=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        epochs()
        torch.cuda.synchronize()
    rows = _device_kernels(prof, 1)
    launches = sum(r[2] for r in rows)
    idle = max(0.0, 1 - sum(r[1] for r in rows) / wall)
    n_upd = c.num_epochs * (c.train_batch_size // c.minibatch_size)
    log(f"[rllib] PPO update_device (minibatch 128, hidden 64): median "
        f"{upd:.3f} ms synchronised, 8 in a row with no host sync (sync "
        f"debug mode 'error'); update_epochs ({n_upd} updates): "
        f"{wall:.2f} ms, {launches:.0f} device ops ({launches / n_upd:.1f} "
        f"an update), device idle share {idle:.3f}; on {card}")
    _report(f"PPO update_epochs ({n_upd} updates)", wall, rows,
            kinds=RL_REPORT_KINDS)


RL_REPORT_KINDS = (("optimizer", ("adam",)), ("gemm", GEMM_NAMES),
                   ("copy", ("memcpy", "memset")))


def device_ops(fn) -> float:
    """The device operations (kernels, copies, fills) of one call of
    ``fn``, counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(r[2] for r in _device_kernels(prof, 1))


def phase_rllib_speed(card: str):
    """Phase 12c: the median synchronised ms and the device operations of
    one update of DQN, SAC and TD3 (critic and actor step) at minibatch
    256, and of IMPALA on one 200-step fragment (its V-trace loop runs a
    step at a time), printed, not held to a limit."""
    from ray_tpu_torch.rllib.core import to_floats

    out = {}
    for kind in ("dqn_double", "sac", "td3", "impala"):
        lrn, _ = rl_learner(kind, "cuda")
        b = rl_batch(kind, 200 if kind == "impala" else 256,
                     np.random.RandomState(0))
        if kind == "td3":
            def fn():
                to_floats(lrn.learn_on_batch(b, do_actor=True))
        else:  # the others' update reads its stats to the host
            def fn():
                lrn.update(b)
        out[kind] = (median_ms(fn), device_ops(fn))
    log(f"[rllib] one update, hidden 64, stats read to the host: median ms "
        f"and device ops " + ", ".join(
            f"{k} {ms:.3f} ({n:.0f})" for k, (ms, n) in out.items())
        + f" (minibatch 256; IMPALA a 200-step fragment); on {card}")


def phase_rllib(card: str):
    """Phase 12: RLlib's learner layer on the card."""
    phase_rllib_parity(card)
    phase_rllib_ppo(card)
    phase_rllib_speed(card)


# ------------------------------------------ RLlib's remaining learners (13)

class NumpyDataset:
    """An in-process dataset of numpy columns with the two methods the
    offline algorithms call (``count`` and ``iter_batches``), in row order
    (the card's machine has no Ray Data)."""

    def __init__(self, columns):
        self.columns = {k: np.asarray(v) for k, v in columns.items()}

    def count(self) -> int:
        return len(next(iter(self.columns.values())))

    def iter_batches(self, batch_size: int, batch_format: str = "numpy",
                     drop_last: bool = False):
        assert batch_format == "numpy", batch_format
        n = self.count()
        for start in range(0, n, batch_size):
            if drop_last and start + batch_size > n:
                break
            yield {k: v[start:start + batch_size]
                   for k, v in self.columns.items()}


RL_MORE_KINDS = ("r2d2", "recurrent_ppo", "bc", "bc_continuous", "marwil",
                 "cql", "crr", "crr_binary", "dt", "qmix", "maddpg",
                 "slateq", "alpha_zero")
# The kinds whose update turns on a discrete choice: R2D2's double-Q pick,
# QMIX's greedy target actions, SlateQ's next slate, CRR's binary weight.
RL_CHOICE_KINDS = ("r2d2", "qmix", "slateq", "crr_binary")
# Geometry: CartPole's 4 observations and 2 actions for the discrete
# single-agent learners; 3 observations and one action in [-1, 1] for the
# offline continuous ones; 2 agents of 3 observations (QMIX: 2 actions,
# MADDPG: one in [-1, 1]); a catalog of 12 items of 4 features, 4 user
# features, slates of 3 (tests/test_rllib_families4.py's recsys); the
# 9-square TicTacToe board.
RL_SLATE_ITEMS = np.random.RandomState(7).randn(12, 4).astype(np.float32)


def rl_more_sizes(kind: str):
    """(the batch's row count, the width) of ``kind`` at its config's
    defaults: the LSTM's width for R2D2 and recurrent PPO, the
    embedding's for DT, the hidden layers' for the rest."""
    from ray_tpu_torch import rllib

    if kind == "r2d2":
        c = rllib.R2D2Config()
        return c.minibatch_size, c.lstm_size
    if kind == "recurrent_ppo":
        c = rllib.RecurrentPPOConfig()
        return c.minibatch_size // c.seq_len, c.lstm_size
    if kind == "dt":
        c = rllib.DTConfig()
        return c.minibatch_size, c.embed_dim
    c = rllib.AlgorithmConfig()
    return c.minibatch_size, c.hidden_size


def rl_more_batch(kind: str, n: int, rng, hidden: int):
    """A seeded numpy batch of ``n`` rows (sequences for R2D2, recurrent
    PPO and DT) in the layout ``kind``'s update takes."""
    from ray_tpu_torch import rllib

    f32 = np.float32

    def mask(L):  # whole sequences and ones that end early (zero-padded)
        m = np.ones((n, L), f32)
        for r in range(n):
            if rng.rand() < 0.3:
                m[r, rng.randint(1, L):] = 0.0
        return m

    if kind in ("r2d2", "recurrent_ppo"):
        c = (rllib.R2D2Config() if kind == "r2d2"
             else rllib.RecurrentPPOConfig())
        L = c.seq_len
        m = mask(L)
        b = {"obs": rng.randn(n, L + (kind == "r2d2"), 4).astype(f32),
             "actions": rng.randint(0, 2, (n, L)).astype(np.int32),
             "mask": m,
             "h0": np.tanh(rng.randn(n, hidden)).astype(f32),
             "c0": rng.randn(n, hidden).astype(f32)}
        if kind == "r2d2":
            b["rewards"] = (rng.randn(n, L) * m).astype(f32)
            b["dones"] = ((rng.rand(n, L) < 0.05) * m).astype(f32)
            return b
        b["old_logp"] = (np.log(rng.uniform(0.2, 0.8, (n, L))) * m
                         ).astype(f32)
        b["adv"] = (rng.randn(n, L) * m).astype(f32)
        b["returns"] = (rng.randn(n, L) * m).astype(f32)
        return b
    if kind == "bc":
        return {"obs": rng.randn(n, 4).astype(f32),
                "act": rng.randint(0, 2, n).astype(np.int64)}
    if kind == "bc_continuous":
        return {"obs": rng.randn(n, 3).astype(f32),
                "act": rng.uniform(-0.9, 0.9, (n, 1)).astype(f32)}
    if kind == "marwil":
        return {"obs": rng.randn(n, 4).astype(f32),
                "actions": rng.randint(0, 2, n).astype(np.int32),
                "returns": (rng.randn(n) * 3).astype(f32),
                "adv_norm": f32(1.7)}
    if kind in ("cql", "crr", "crr_binary"):
        return {"obs": rng.randn(n, 3).astype(f32),
                "act": rng.uniform(-1, 1, (n, 1)).astype(f32),
                "rew": rng.randn(n).astype(f32),
                "next_obs": rng.randn(n, 3).astype(f32),
                "done": (rng.rand(n) < 0.1).astype(f32)}
    if kind == "dt":
        K = rllib.DTConfig().context_length
        m = mask(K)
        acts = rng.randint(0, 2, (n, K)).astype(np.int32)
        act_in = np.full((n, K), 2, np.int32)          # 2 = BOS/pad
        act_in[:, 1:] = acts[:, :-1]
        start = rng.randint(0, 40, n)
        return {"obs": (rng.randn(n, K, 3) * m[..., None]).astype(f32),
                "actions": (acts * m).astype(np.int32),
                "act_in": act_in,
                "rtg": (rng.randn(n, K, 1) * 3).astype(f32),
                "timesteps": ((start[:, None] + np.arange(K)) * m
                              ).astype(np.int32),
                "mask": m}
    if kind == "qmix":
        obs = rng.randn(n, 2, 3).astype(f32)
        nxt = rng.randn(n, 2, 3).astype(f32)
        return {"obs": obs, "state": obs.reshape(n, -1),
                "actions": rng.randint(0, 2, (n, 2)).astype(np.int32),
                "rew": rng.randn(n).astype(f32),
                "done": (rng.rand(n) < 0.1).astype(f32),
                "next_obs": nxt, "next_state": nxt.reshape(n, -1)}
    if kind == "maddpg":
        return {"obs": rng.randn(n, 2, 3).astype(f32),
                "actions": rng.uniform(-1, 1, (n, 2, 1)).astype(f32),
                "rew": rng.randn(n, 2).astype(f32),
                "done": (rng.rand(n) < 0.1).astype(f32),
                "next_obs": rng.randn(n, 2, 3).astype(f32)}
    if kind == "slateq":
        slate = np.stack([rng.choice(12, 3, replace=False)
                          for _ in range(n)]).astype(np.int32)
        pos = rng.randint(0, 4, n)                     # 3 = no click
        clicked = np.where(pos < 3, slate[np.arange(n),
                                          np.minimum(pos, 2)], -1)
        return {"user": rng.randn(n, 4).astype(f32), "slate": slate,
                "clicked": clicked.astype(np.int32),
                "rew": rng.randn(n).astype(f32),
                "next_user": rng.randn(n, 4).astype(f32),
                "done": (rng.rand(n) < 0.1).astype(f32)}
    assert kind == "alpha_zero", kind
    pi = rng.dirichlet(np.ones(9) * 0.5, n)
    return {"s": rng.randint(-1, 2, (n, 9)).astype(f32), "pi": pi,
            "z": rng.randint(-1, 2, n).astype(f32)}


def rl_more_learner(kind: str, device, hidden: int):
    """(learner, step(batch, i) -> {stat: tensor or float}): one learner of
    ``kind`` at its config's defaults and width ``hidden``, run the way
    its algorithm runs it (the target synced after update 0 where the
    algorithm hard-syncs one)."""
    import pickle

    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.core import to_floats
    from ray_tpu_torch.rllib.policy import QPolicy
    from ray_tpu_torch.rllib.slateq import _SlatePolicy

    def synced(lrn, update):
        def step(b, i):
            out = update(b)
            if i == 0:
                lrn.sync_target()
            return out
        return step

    if kind == "r2d2":
        c = rllib.R2D2Config()
        lrn = rllib.R2D2Learner(4, 2, hidden, c.lr, c.gamma, c.seed,
                                device=device)
        return lrn, synced(lrn, lambda b: {"loss": lrn.learn_on_batch(b)})
    if kind == "recurrent_ppo":
        c = rllib.RecurrentPPOConfig()
        c.lstm_size = hidden
        lrn = rllib.RecurrentPPOLearner(4, 2, c, device=device)
        return lrn, lambda b, i: {"loss": lrn.learn_on_batch(b)}
    if kind in ("bc", "bc_continuous"):
        c = rllib.BCConfig()
        c.hidden_size = hidden
        if kind == "bc":
            c.num_actions = 2
            probe = {"obs": np.zeros((1, 4), np.float32),
                     "act": np.zeros(1, np.int64)}
        else:
            c.action_space = "continuous"
            probe = {"obs": np.zeros((1, 3), np.float32),
                     "act": np.zeros((1, 1), np.float32)}
        c.offline_data(NumpyDataset(probe), action_column="act")
        lrn = c.build(device=device)
        return lrn, lambda b, i: {
            "loss": float(lrn.learn_on_batch(b["obs"], b["act"]))}
    if kind == "marwil":
        c = rllib.MARWILConfig()
        lrn = rllib.MARWILLearner(
            rllib.ActorCriticModule(4, 2, hidden, c.seed).init_params(),
            lr=c.lr, beta=c.beta, vf_coeff=c.vf_coeff, device=device)
        return lrn, lambda b, i: lrn.update(b)
    if kind in ("cql", "crr", "crr_binary"):
        c = rllib.CQLConfig() if kind == "cql" else rllib.CRRConfig()
        c.hidden_size = hidden
        if kind == "crr_binary":
            c.weight_type = "binary"
        cls = rllib.CQLLearner if kind == "cql" else rllib.CRRLearner
        lrn = cls(c, 3, 1, device=device)
        return lrn, lambda b, i: to_floats(lrn.learn_on_batch(b))
    if kind == "dt":
        c = rllib.DTConfig()
        c.num_actions, c.embed_dim = 2, hidden
        lrn = rllib.DTLearner(c, 3, device=device)
        return lrn, lambda b, i: {"loss": lrn.train_batch(b)}
    if kind == "qmix":
        c = rllib.QMIXConfig()
        lrn = rllib.QMIXLearner(
            QPolicy(3, 2, hidden, c.seed).get_weights(), n_agents=2,
            obs_dim=3, num_actions=2, state_dim=6,
            embed=c.mixing_embed_dim, lr=c.lr, gamma=c.gamma, seed=c.seed,
            device=device)
        return lrn, synced(lrn, lambda b: to_floats(lrn.update_qmix(b)))
    if kind == "maddpg":
        c = rllib.MADDPGConfig()
        lrn = rllib.MADDPGLearner(2, 3, 1, hidden, c.lr, c.tau, c.gamma,
                                  c.seed, device=device)
        return lrn, lambda b, i: to_floats(lrn.learn_on_batch(b))
    if kind == "slateq":
        c = rllib.SlateQConfig()
        lrn = rllib.SlateQLearner(
            _SlatePolicy(4, 4, 12, 3, hidden, c.seed), RL_SLATE_ITEMS, 3,
            c.lr, c.gamma, device=device)
        return lrn, synced(lrn, lambda b: {"loss": lrn.learn_on_batch(b)})
    assert kind == "alpha_zero", kind
    c = rllib.AlphaZeroConfig()
    c.hidden_size = hidden
    assert pickle.loads(pickle.dumps(c.game)) is rllib.TicTacToe
    lrn = rllib.AlphaZeroLearner(c, device=device)
    return lrn, lambda b, i: lrn.update(b["s"], b["pi"], b["z"])


def rl_more_choices(kind: str, lrn, batch):
    """The discrete choices the next update of ``kind`` turns on, from the
    learner's current weights, as numpy."""
    from ray_tpu_torch.rllib.core import DeterministicActorModule

    dev = lrn.device

    def t(key):
        return torch.from_numpy(np.ascontiguousarray(batch[key])).to(dev)

    with torch.no_grad():
        if kind == "r2d2":
            q = lrn.q_unroll(lrn._params, t("obs"), t("h0"), t("c0"))
            out = lrn.next_actions(q)
        elif kind == "qmix":
            out = lrn.agent_q(lrn._target_full["agent"],
                              t("next_obs")).argmax(-1)
        elif kind == "slateq":
            out = lrn.next_slates(lrn._target, t("next_user"))[0]
        else:
            p = lrn._params
            pi = DeterministicActorModule.forward(p["actor"], t("obs"))
            out = lrn.advantage(p["q1"], t("obs"), t("act"), pi) > 0
    return out.cpu().numpy()


def dt_split_key_biases(state, D: int):
    """DT's key biases moved out of a flat state ({path: array}): (the
    rest, [each layer's key bias]). A key bias is the middle third of a
    layer's qkv bias. Its gradient is zero in exact arithmetic (softmax
    does not change when every logit of a row moves by the same q . b_k),
    so Adam steps each entry by the rounding noise of that gradient, up to
    lr a step, and two devices (or two frameworks) move it apart. It is
    held by its effect instead: dt_key_bias_effect."""
    rest, keys = dict(state), []
    for path in sorted(p for p in state if p.endswith("qkv.0.1")):
        b = state[path]
        rest[path] = np.concatenate([b[:D], b[2 * D:]])
        keys.append(b[D:2 * D])
    return rest, keys


def dt_key_bias_effect(lrn, keys, batch) -> float:
    """The largest change of the DT learner's logits on ``batch`` when its
    key biases are replaced by ``keys`` (one array a layer)."""
    from ray_tpu_torch.rllib.core import tree_map

    dev, D = lrn.device, lrn._D
    x = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
         for k in ("rtg", "obs", "act_in", "timesteps")}
    swapped = tree_map(lambda t: t, lrn._params)
    for layer, kb in enumerate(keys):
        (W, b), = swapped[f"attn_{layer}"]["qkv"]
        b = b.clone()
        b[D:2 * D] = torch.from_numpy(np.array(kb)).to(dev)
        swapped[f"attn_{layer}"] = {**swapped[f"attn_{layer}"],
                                    "qkv": [(W, b)]}
    with torch.no_grad():
        args = (x["rtg"], x["obs"], x["act_in"], x["timesteps"])
        return float((lrn.forward(swapped, *args)
                      - lrn.forward(lrn._params, *args)).abs().max())


def phase_rllib_more_parity(card: str):
    """Phase 13a: each new learner's three updates on the card against
    the same three on the CPU, float32 with TF32 off, under 12a's bounds;
    the discrete choices of R2D2, QMIX, SlateQ and CRR-binary equal
    before each update."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for kind in RL_MORE_KINDS:
            n, hidden = rl_more_sizes(kind)
            batches = [rl_more_batch(kind, n, np.random.RandomState(i),
                                     hidden) for i in range(3)]
            runs, choices = {}, {}
            for dev in ("cuda", "cpu"):
                lrn, step = rl_more_learner(kind, dev, hidden)
                stats = []
                for i, b in enumerate(batches):
                    if kind in RL_CHOICE_KINDS:
                        choices.setdefault(dev, []).append(
                            rl_more_choices(kind, lrn, b))
                    stats.append({k: float(v) for k, v in
                                  step(b, i).items()})
                runs[dev] = (stats, rl_state(lrn), lrn)
            for g, c in zip(choices.get("cuda", []),
                            choices.get("cpu", [])):
                assert np.array_equal(g, c), (kind, g, c)
            (gs, gw, glrn), (cs, cw, _) = runs["cuda"], runs["cpu"]
            share = {}
            for g, c in zip(gs, cs):
                assert g.keys() == c.keys(), (kind, g, c)
                for k in c:
                    share[k] = max(share.get(k, 0.0), abs(g[k] - c[k])
                                   / (1e-5 * abs(c[k]) + 1e-6))
            keys = ""
            if kind == "dt":
                (gw, gk), (cw, ck) = (dt_split_key_biases(w, hidden)
                                      for w in (gw, cw))
                k_err = max(float(np.abs(g - c).max())
                            for g, c in zip(gk, ck))
                effect = dt_key_bias_effect(glrn, ck, batches[0])
                keys = (f"; key biases (zero gradient) apart by "
                        f"{k_err:.2e}, the card's logits moved "
                        f"{effect:.2e} by the CPU's (bound 1e-5)")
                assert effect <= 1e-5, (kind, effect)
            w_err = max(float(np.abs(gw[k] - cw[k]).max()) for k in cw)
            picks = (f"{sum(x.size for x in choices['cpu'])} discrete "
                     "choices equal; " if kind in RL_CHOICE_KINDS else "")
            log(f"[rllib] {kind}: 3 updates card vs CPU ({n} rows, width "
                f"{hidden}); {picks}worst share of the stat bound 1e-5 "
                f"|CPU| + 1e-6 {max(share.values()):.3f} ("
                + ", ".join(f"{k} {v:.3f}" for k, v in share.items())
                + f"); worst weight error {w_err:.2e} (bound 1e-4) over "
                f"{len(cw)} tensors{keys}; on {card}")
            assert max(share.values()) <= 1.0, (kind, gs, cs)
            assert w_err <= 1e-4, (kind, w_err)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def bc_data(rng):
    """tests/test_rllib.py's BC data: 1,024 rows of 4 observations and the
    expert's action (obs0 + obs1 > 0), and 256 held-out rows."""
    obs = rng.randn(1024, 4).astype(np.float32)
    test_obs = rng.randn(256, 4).astype(np.float32)
    return (NumpyDataset({"obs": obs, "action": (obs[:, 0] + obs[:, 1] > 0
                                                 ).astype(np.int64)}),
            test_obs, (test_obs[:, 0] + test_obs[:, 1] > 0))


def dt_data(rng):
    """tests/test_rllib_families3.py's DT data: 120 episodes of length 6;
    the signal is the observation, even episodes act on its sign (+1 a
    step), odd ones against it (-1)."""
    cols = {"episode_id": [], "t": [], "obs": [], "action": [],
            "reward": []}
    for ep in range(120):
        for t in range(6):
            sig = float(rng.choice([-1.0, 1.0]))
            want = 1 if sig > 0 else 0
            act = want if ep % 2 == 0 else 1 - want
            for k, v in (("episode_id", ep), ("t", t),
                         ("obs", np.asarray([sig], np.float32)),
                         ("action", act),
                         ("reward", 1.0 if act == want else -1.0)):
                cols[k].append(v)
    return NumpyDataset(cols)


def dt_accuracy(algo, trials: int = 40) -> float:
    """The share of fresh signals on which DT, conditioned on the
    expert's return (+6), picks the right action."""
    correct = 0
    for i in range(trials):
        sig = 1.0 if i % 2 == 0 else -1.0
        a = algo.compute_action({"obs": [np.asarray([sig], np.float32)],
                                 "actions": [], "rewards": []},
                                target_return=6.0)
        correct += int(a == (1 if sig > 0 else 0))
    return correct / trials


def alpha_zero_iterations(learner, cfg, iters: int, actors=2):
    """``iters`` of the JAX package's AlphaZero.train() in one process:
    local _SelfPlayActors (seeds seed + i) play games_per_iteration games
    with the learner's weights, then train_batches_per_iteration
    minibatches drawn from the replay by RandomState(seed + 17) update it.
    Gives each iteration's last stats and new positions."""
    import pickle

    from ray_tpu_torch.rllib.alpha_zero import _SelfPlayActor

    players = [_SelfPlayActor(pickle.dumps(cfg.game), cfg.num_simulations,
                              cfg.seed + i) for i in range(actors)]
    rng = np.random.RandomState(cfg.seed + 17)
    replay, out = [], []
    for _ in range(iters):
        weights = learner.get_weights()
        for p in players:
            p.set_weights(weights)
        per = max(1, cfg.games_per_iteration // actors)
        results = [p.play_games(per) for p in players]
        replay.extend(results)
        while sum(len(r[0]) for r in replay) > cfg.replay_window \
                and len(replay) > 1:
            replay.pop(0)
        S, PI, Z = (np.concatenate([r[k] for r in replay])
                    for k in range(3))
        for _ in range(cfg.train_batches_per_iteration):
            idx = rng.randint(0, len(S), min(cfg.minibatch_size, len(S)))
            stats = learner.update(S[idx], PI[idx], Z[idx])
        out.append({**stats, "num_positions": len(S),
                    "new_positions": sum(len(r[0]) for r in results)})
    return out, (S, PI, Z)


def alpha_zero_loss(learner, positions) -> float:
    """The learner's total loss over ``positions`` (S, PI, Z), no step."""
    from ray_tpu_torch.rllib.core import to_device

    with torch.no_grad():
        loss, _ = learner._loss(learner._params, *(
            to_device(x, learner.device) for x in positions))
    return float(loss)


def phase_rllib_more_learn(card: str):
    """Phase 13b: BC, DT and AlphaZero learn on the card through the
    ported algorithms, to the JAX package's own tests' criteria."""
    from ray_tpu_torch import rllib

    t0 = time.perf_counter()
    ds, test_obs, want = bc_data(np.random.RandomState(0))
    bc = (rllib.BCConfig().offline_data(ds)
          .training(lr=5e-3, minibatch_size=256, num_actions=2).build())
    assert bc.device.type == "cuda", bc.device
    for _ in range(25):
        last = bc.train()
    logits, _ = bc.get_policy().logits_and_value(test_obs)
    acc = float((logits.argmax(axis=1) == want).mean())
    t1 = time.perf_counter()
    log(f"[rllib] BC on the card, 25 passes over 1,024 rows (lr 5e-3, "
        f"minibatch 256): loss {last['loss']:.4f} (need < 0.3), held-out "
        f"accuracy {acc:.3f} on 256 rows (need > 0.9); "
        f"{(t1 - t0) * 1e3:.0f} ms; on {card}")
    assert last["num_rows_trained"] == 1024 and last["loss"] < 0.3, last
    assert acc > 0.9, acc

    dt = (rllib.DTConfig().offline_data(dt_data(np.random.RandomState(0)))
          .training(lr=2e-3, minibatch_size=64, num_actions=2,
                    context_length=6).debugging(seed=0).build())
    assert dt.learner.device.type == "cuda", dt.learner.device
    losses = [dt.train()["loss"] for _ in range(15)]
    acc = dt_accuracy(dt)
    t2 = time.perf_counter()
    log(f"[rllib] DT on the card, 120 episodes of 6, 15 iterations of 32 "
        f"minibatches of 64: loss by iteration "
        f"{[round(x, 4) for x in losses]} (need last < first), accuracy "
        f"{acc:.3f} on 40 fresh signals at target return 6 (need > 0.85); "
        f"{(t2 - t1) * 1e3:.0f} ms; on {card}")
    assert losses[-1] < losses[0], losses
    assert acc > 0.85, acc

    cfg = (rllib.AlphaZeroConfig().training(lr=3e-3, minibatch_size=128)
           .debugging(seed=0))
    cfg.num_simulations = 32
    cfg.games_per_iteration = 10
    cfg.train_batches_per_iteration = 12
    learner = rllib.AlphaZeroLearner(cfg)
    assert learner.device.type == "cuda", learner.device
    initial = rllib.AlphaZeroLearner(cfg)
    its, replay = alpha_zero_iterations(learner, cfg, 2)
    before, after = (alpha_zero_loss(x, replay) for x in (initial, learner))
    t3 = time.perf_counter()
    log(f"[rllib] AlphaZero on the card, 2 iterations of 10 TicTacToe "
        f"self-play games (32 simulations a move, two local "
        f"_SelfPlayActors) and 12 minibatches of 128: total loss over the "
        f"{len(replay[0])} positions of both iterations {before:.4f} with "
        f"the initial net -> {after:.4f} trained (need it to fall); each "
        f"iteration's last minibatch: total {its[0]['total_loss']:.4f}, "
        f"{its[1]['total_loss']:.4f}, policy {its[0]['policy_loss']:.4f}, "
        f"{its[1]['policy_loss']:.4f}, value {its[0]['value_loss']:.4f}, "
        f"{its[1]['value_loss']:.4f}; positions {its[0]['num_positions']}"
        f" -> {its[1]['num_positions']}; {(t3 - t2) * 1e3:.0f} ms; on "
        f"{card}")
    assert after < before, (before, after, its)
    assert its[1]["num_positions"] > its[0]["new_positions"], its


def phase_rllib_more_speed(card: str):
    """Phase 13c: the median synchronised ms and the device operations of
    one update of each new learner at its config's defaults, stats read
    to the host; printed, not held to a limit."""
    out = {}
    for kind in RL_MORE_KINDS:
        n, hidden = rl_more_sizes(kind)
        lrn, step = rl_more_learner(kind, "cuda", hidden)
        b = rl_more_batch(kind, n, np.random.RandomState(0), hidden)

        def fn():
            step(b, 1)  # i = 1: no target sync, the update alone

        out[kind] = (n, median_ms(fn), device_ops(fn))
    log(f"[rllib] one update at the configs' defaults, stats read to the "
        f"host: median ms and device ops " + ", ".join(
            f"{k} {ms:.3f} ({ops:.0f}; {n} rows)"
            for k, (n, ms, ops) in out.items())
        + f" (R2D2: sequences of 13 steps, width 32; recurrent PPO: "
        f"sequences of 8, width 32; DT: windows of 8, width 64; the rest "
        f"width 64); on {card}")


def phase_rllib_more(card: str):
    """Phase 13: RLlib's remaining learners on the card."""
    phase_rllib_more_parity(card)
    phase_rllib_more_learn(card)
    phase_rllib_more_speed(card)


# ------------------------------------------- the runtime and trainer (14)

RUNTIME_FLASH = dict(B=1, S=512, H=32, Hkv=8, D=128, seed=14)
TRAINER_STEPS = 4
TRAINER_CKPT_STEPS = (1, 3)
TRAINER_CRASH_STEP = 2


def runtime_flash_inputs(device):
    """Phase 14a's seeded bf16 flash inputs, [B, S, H, D]."""
    c = RUNTIME_FLASH
    rs = np.random.RandomState(c["seed"])

    def draw(h):
        a = rs.standard_normal((c["B"], c["S"], h, c["D"]))
        return torch.tensor(a, dtype=torch.bfloat16, device=device)

    return draw(c["H"]), draw(c["Hkv"]), draw(c["Hkv"])


def runtime_gpu_task():
    """A num_gpus=1 task: what it sees, and a flash forward on the card."""
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = runtime_flash_inputs("cuda")
    fa.launches = 0
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            torch.cuda.get_device_name(0), out.cpu(), fa.launches)


def runtime_cpu_task():
    return os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.is_available()


def runtime_noop():
    return None


class RuntimeNoop:
    """A no-op actor (one per worker process)."""

    def noop(self):
        return None


def trainer_config():
    from ray_tpu_torch.models import LlamaConfig

    return dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=2)


def trainer_tokens(cfg, device):
    """Phase 14b's seeded token batches, B = 1, S = 2048 (+1 for targets)."""
    rs = np.random.RandomState(14)
    return [torch.tensor(rs.randint(0, cfg.vocab_size, (1, 2049)),
                         dtype=torch.int32, device=device)
            for _ in range(TRAINER_STEPS)]


def trainer_loop(config):
    """Phase 14b's train loop, run by TorchTrainer in a GPU worker: the
    2-layer 8B at B = 1, S = 2048 from seed 0, a committed checkpoint after
    steps 1 and 3; the first attempt dies (os._exit) at step 2, the next
    resumes from step 1's checkpoint. Each report carries the loss, the
    step's ms and this process's flash launch counts since the loop began."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint, CompiledTrainStep

    sess = train.get_session()
    assert train.get_device().type == "cuda"
    train_launches(reset=True)
    cfg = trainer_config()
    step = CompiledTrainStep(cfg, learning_rate=1e-3)
    start = sess.get_checkpoint()
    if start is not None:
        state = start.as_pytree()
        params, opt, first = state["params"], state["opt_state"], \
            state["step"] + 1
    else:
        params, opt = step.init(torch.Generator(device="cuda").manual_seed(0))
        first = 0
    toks = trainer_tokens(cfg, "cuda")
    for i in range(first, TRAINER_STEPS):
        if i == TRAINER_CRASH_STEP and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            os._exit(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, toks[i])
        loss = loss.item()
        ms = (time.perf_counter() - t0) * 1e3
        ckpt = None
        if i in TRAINER_CKPT_STEPS:
            ckpt = Checkpoint.from_pytree(
                {"params": params, "opt_state": opt, "step": i},
                sess.checkpoint_dir(i), step=i)
        train.report({"step": i, "loss": loss, "step_ms": ms,
                      "pid": os.getpid(), **train_launches()},
                     checkpoint=ckpt)


def alive_pids(pids):
    """The pids of ``pids`` that are still running (zombies count dead)."""
    out = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    out.append(pid)
        except OSError:
            pass
    return out


def phase_runtime(card: str):
    """Phase 14a: the port's runtime on the card: GPU and CPU tasks in
    their own worker types, a GPU task's flash forward equal to the
    driver's bitwise, the card held by a GPU actor, start and round-trip
    times."""
    import chip_smoke as cs  # the functions travel as chip_smoke.<name>
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_context import current_runtime
    from ray_tpu_torch.ops import flash_attention as fa

    rt.init(num_cpus=2)
    res = rt.cluster_resources()
    assert res.get("GPU") == torch.cuda.device_count(), res
    t0 = time.perf_counter()
    visible, name, out, launches = rt.get(
        rt.remote(cs.runtime_gpu_task).options(num_gpus=1).remote())
    first_gpu_s = time.perf_counter() - t0
    q, k, v = runtime_flash_inputs("cuda")
    want = fa.flash_attention(q, k, v, causal=True).cpu()
    bitwise = torch.equal(out, want)
    cpu_visible, cpu_cuda = rt.get(rt.remote(cs.runtime_cpu_task).remote())
    driver_visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    log(f"[runtime] {res}; GPU task: CUDA_VISIBLE_DEVICES={visible!r} "
        f"(driver's {driver_visible!r}), {name}, flash forward B=1 S=512 "
        f"bf16 {'bitwise equal to' if bitwise else 'DIFFERS from'} the "
        f"driver's, {launches} launch in the worker, first GPU task "
        f"{first_gpu_s:.2f} s with the worker's start; CPU task: "
        f"CUDA_VISIBLE_DEVICES={cpu_visible!r}, cuda available {cpu_cuda}; "
        f"on {card}")
    assert bitwise and launches == 1, (bitwise, launches)
    assert name == torch.cuda.get_device_name(0)
    want_visible = driver_visible.split(",")[0].strip() \
        if driver_visible else "0"
    assert visible == want_visible, (visible, want_visible)
    assert cpu_visible == "" and cpu_cuda is False

    holder = rt.remote(cs.RuntimeNoop).options(num_gpus=1).remote()
    rt.get(holder.noop.remote())
    waiting = rt.remote(cs.runtime_cpu_task).options(num_gpus=1).remote()
    ready, _ = rt.wait([waiting], timeout=1.0)
    held = not ready
    rt.kill(holder)
    after = rt.get(waiting, timeout=120)
    log(f"[runtime] a second num_gpus=1 task while a GPU actor holds the "
        f"card: {'not ready' if held else 'READY'} after wait(timeout=1.0);"
        f" after kill() it ran and saw CUDA_VISIBLE_DEVICES={after[0]!r}")
    assert held and after[1] is True, (held, after)

    starts = {}
    for kind, opts in (("gpu", {"num_gpus": 1}), ("cpu", {})):
        t0 = time.perf_counter()
        a = rt.remote(cs.RuntimeNoop).options(**opts).remote()
        rt.get(a.__rtpu_ping__.remote())
        starts[kind] = (time.perf_counter() - t0) * 1e3
        if kind == "gpu":
            rt.kill(a)
        else:
            actor = a

    def median_wall_ms(fn, n=100):
        fn()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    noop = rt.remote(cs.runtime_noop)
    task_ms = median_wall_ms(lambda: rt.get(noop.remote()))
    call_ms = median_wall_ms(lambda: rt.get(actor.noop.remote()))
    log(f"[runtime] worker start to a first actor call: GPU-typed "
        f"{starts['gpu']:.1f} ms, CPU-typed {starts['cpu']:.1f} ms; median "
        f"of 100 no-op task round trips {task_ms:.3f} ms, of 100 no-op actor"
        f" calls {call_ms:.3f} ms (host times, not held); on {card}")
    pids = current_runtime().worker_pids()
    rt.shutdown()
    time.sleep(0.2)
    left = alive_pids(pids)
    log(f"[runtime] shutdown(): {len(pids)} worker processes, alive after: "
        f"{left}")
    assert not left, left


def phase_trainer(card: str):
    """Phase 14b: the 2-layer 8B trained by TorchTrainer in a GPU worker,
    across a crash and a restart from the step-1 checkpoint, against 4
    steps straight in the driver."""
    import shutil

    import chip_smoke as cs
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_context import current_runtime
    from ray_tpu_torch.train import (
        CompiledTrainStep, FailureConfig, RunConfig, ScalingConfig,
        TorchTrainer)

    cfg = trainer_config()
    toks = trainer_tokens(cfg, "cuda")
    step = CompiledTrainStep(cfg, learning_rate=1e-3)
    params, opt = step.init(torch.Generator(device="cuda").manual_seed(0))
    straight, driver_ms = [], []
    for t in toks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, t)
        straight.append(loss.item())
        driver_ms.append((time.perf_counter() - t0) * 1e3)
    TRAINER_STRAIGHT.update(losses=list(straight), ms=list(driver_ms))
    state = {"params": params, "opt_state": opt}
    nbytes = tree_bytes(state)
    ref = [t.cpu() for t in tree_tensors(state)]
    del params, opt, step, state, toks, loss
    torch.cuda.empty_cache()

    path = ckpt_dir("trainer", 2 * nbytes, card)
    restarts0 = counts_by("ray_tpu_train_restarts_total", "reason")
    rt.init(num_cpus=2)
    try:
        t0 = time.perf_counter()
        result = TorchTrainer(
            cs.trainer_loop,
            train_loop_config={"marker": os.path.join(path, "crashed")},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(
                storage_path=path,
                failure_config=FailureConfig(max_failures=1)),
        ).fit()
        fit_s = time.perf_counter() - t0
        pids = current_runtime().worker_pids()
        assert result.error is None, result.error
        hist = result.metrics_history
        got = result.checkpoint.as_pytree(device="cpu")
        worst = 0.0
        for a, b in zip(tree_tensors({"params": got["params"],
                                      "opt_state": got["opt_state"]}), ref):
            top = b.abs().max().item()
            if top:
                worst = max(worst, (a.float() - b.float()).abs().max().item()
                            / top)
        ckpt_step = got["step"]
        del got, ref
    finally:
        rt.shutdown()
        shutil.rmtree(path, ignore_errors=True)
    time.sleep(0.2)
    left = alive_pids(pids)
    losses = [m["loss"] for m in hist]
    restarts = grown(counts_by("ray_tpu_train_restarts_total", "reason"),
                     restarts0)
    from ray_tpu_torch.util import metrics

    rec = metrics.get_metrics_report()["ray_tpu_train_recovery_seconds"][
        "series"][()]
    launches = {k: hist[-1][k] for k in TRAIN_COUNTERS}
    worker_ms = [m["step_ms"] for m in hist]
    # Each process's first step warms the card up (cuBLAS handles, the
    # allocator); the steady steps are the others.
    steady_worker = [m["step_ms"] for m in hist
                     if m["step"] not in (0, TRAINER_CRASH_STEP)]
    steady_driver = driver_ms[1:]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, straight))
    exact = losses == straight
    log(f"[trainer] TorchTrainer, 2-layer llama3_8b ({nbytes / 1e9:.3f} GB "
        f"of state), B=1 S=2048, a GPU worker, os._exit(1) at step 2, "
        f"restarted from step 1's checkpoint: fit {fit_s:.2f} s wall, "
        f"recovery {rec['sum']:.3f} s (ray_tpu_train_recovery_seconds, "
        f"{rec['count']} observation), restarts {restarts}; steps reported "
        f"{[m['step'] for m in hist]} by pids {[m['pid'] for m in hist]}")
    log(f"[trainer] losses {losses} against 4 steps straight in the driver "
        f"{straight}: {'identical' if exact else 'differ'}; worst loss "
        f"relative difference {loss_rel:.3e}; step-{ckpt_step} checkpoint "
        f"against the straight run's params and moments: worst max|d| / "
        f"max|ref| {worst:.3e} (tol 1e-6); worker launches after the "
        f"restart {launches}; worker processes alive after shutdown {left}")
    log(f"[trainer] median steady step ms in the worker "
        f"{np.median(steady_worker):.3f} against in the driver "
        f"{np.median(steady_driver):.3f} (each process's first step, its "
        f"warm-up, left out; all steps: worker "
        f"{[round(x, 3) for x in worker_ms]}, driver "
        f"{[round(x, 3) for x in driver_ms]}); on {card}")
    assert len(losses) == TRAINER_STEPS and [m["step"] for m in hist] == \
        list(range(TRAINER_STEPS)), hist
    assert exact or loss_rel <= 1e-6, (losses, straight)
    assert ckpt_step == TRAINER_CKPT_STEPS[-1] and worst <= 1e-6, worst
    assert restarts == {"error": 1.0}, restarts
    assert all(launches[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv_per_head")), launches
    assert not left, left
    return launches


# ------------------------------------------------------ the data plane (15)

DATA_ROWS, DATA_BLOCKS, DATA_WIDTH = 4096, 16, 256
PREDICT = dict(rows=64, S=512, batch=8, seed=15)
# The scorer call profiled in the actor: the last, since the profiler's
# first session in a process takes seconds to start.
PREDICT_PROFILED_CALL = PREDICT["rows"] // PREDICT["batch"]
_predict_calls = []  # the scorer's calls in this process
TRAINER_STRAIGHT = {}  # phase 14b's straight run: losses, step ms


def data_features(batch):
    """Phase 15a's map_batches: a unique sort key and DATA_WIDTH float32
    features made from each id."""
    ids = batch["id"]
    freq = np.arange(1, DATA_WIDTH + 1, dtype=np.float64) * 1e-3
    return {"id": ids, "key": (ids * 2654435761) % (1 << 32),
            "x": np.sin(ids[:, None] * freq).astype(np.float32)}


def data_keep(row):
    return row["id"] % 3 != 0


DATA_ORDERED = {"map_batches": True, "filter": True, "random_shuffle": False,
                "sort": True, "union": True}


def data_run(rd):
    """Phase 15a's plan built and run stage by stage, each stage's wall
    the plan from its source (a shuffle runs when it is built); then the
    union's streaming_split(2) read by two threads. Returns ({stage:
    (columns, s, blocks)}, the split's columns, its s, blocks a shard)."""
    import chip_smoke as cs  # the functions travel as chip_smoke.<name>

    out = {}

    def run(name, build):
        t0 = time.perf_counter()
        ds = build()
        blocks = list(ds.iter_batches(batch_size=None))
        s = time.perf_counter() - t0
        cols = {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
        out[name] = (cols, s, len(blocks))
        return ds

    mapped = run("map_batches", lambda: rd.range(
        DATA_ROWS, override_num_blocks=DATA_BLOCKS).map_batches(
            cs.data_features))
    kept = run("filter", lambda: mapped.filter(cs.data_keep))
    shuffled = run("random_shuffle", lambda: kept.random_shuffle(seed=0))
    ordered = run("sort", lambda: shuffled.sort("key"))
    united = run("union", lambda: ordered.union(rd.range(
        512, override_num_blocks=4).map_batches(cs.data_features)))
    t0 = time.perf_counter()
    shards = united.streaming_split(2)
    got = [[], []]

    def consume(i):
        got[i] = list(shards[i].iter_batches(batch_size=None))

    threads = [threading.Thread(target=consume, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a split shard hung"
    split_s = time.perf_counter() - t0
    blocks = got[0] + got[1]
    return out, {k: np.concatenate([b[k] for b in blocks])
                 for k in blocks[0]}, split_s, [len(g) for g in got]


def by_id(cols):
    """The columns' rows sorted by (id, key): the order-free view."""
    idx = np.lexsort((cols["key"], cols["id"]))
    return {k: v[idx] for k, v in cols.items()}


def same_rows(a, b, ordered: bool) -> bool:
    if not ordered:
        a, b = by_id(a), by_id(b)
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)


def phase_data(card: str):
    """Phase 15a: the Data plane in CPU workers of the port's runtime
    against the same plan run locally, stage by stage."""
    import chip_smoke as cs
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd

    local, local_split, local_split_s, _ = data_run(rd)
    rt.init(num_cpus=2)
    try:
        t0 = time.perf_counter()  # the workers' start and imports
        rd.range(8, override_num_blocks=2).map_batches(
            cs.data_features).count()
        warm_s = time.perf_counter() - t0
        remote, remote_split, split_s, per_shard = data_run(rd)
    finally:
        rt.shutdown()
    log(f"[data] init(num_cpus=2): the workers' start and a first 2-block "
        f"plan {warm_s:.2f} s; range({DATA_ROWS}, {DATA_BLOCKS} blocks) -> "
        f"map_batches (id, key, {DATA_WIDTH} float32 features) -> filter "
        f"-> random_shuffle(seed=0) -> sort(key) -> union(range(512)) -> "
        f"streaming_split(2), on {card}")
    bad = []
    for name, ordered in DATA_ORDERED.items():
        (rc, rs, rb), (lc, ls, _) = remote[name], local[name]
        nbytes = sum(v.nbytes for v in rc.values())
        ok = same_rows(rc, lc, ordered)
        if not ok:
            bad.append(name)
        log(f"[data] {name} (the plan to here): {len(rc['id'])} rows, "
            f"{rb} blocks, "
            f"{nbytes / 1e6:.3f} MB; remote {rs:.3f} s ({rb / rs:.1f} "
            f"blocks/s, {nbytes / rs / 1e6:.2f} MB/s) against local "
            f"{ls:.3f} s; rows {'equal' if ok else 'DIFFER'} "
            f"({'in order' if ordered else 'as a multiset'})")
    split_ok = same_rows(remote_split, local_split, False)
    log(f"[data] streaming_split(2) over the union through the coordinator "
        f"actor, two threads: {per_shard} blocks a shard, "
        f"{len(remote_split['id'])} rows in {split_s:.3f} s (the "
        f"coordinator's worker start and imports included) against local "
        f"{local_split_s:.3f} s; rows {'equal' if split_ok else 'DIFFER'} "
        f"as a multiset; on {card}")
    assert not bad and split_ok and all(per_shard), (bad, per_shard)


def score_rows(params, tokens, cfg):
    """Each row's mean log-probability of its own next tokens and its last
    position's argmax next token (no logits leave: a batch's are 1 GB)."""
    from ray_tpu_torch.models.llama import forward

    with torch.inference_mode():
        logits, _ = forward(params, tokens, cfg)
        logp = torch.log_softmax(logits[:, :-1], -1)
        own = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        return {"logprob": own.mean(-1), "next_token": logits[:, -1].argmax(-1)}


def predict_score(params, tokens):
    """Phase 15b's apply_fn, run by TorchPredictor in the GPU actor: the
    scores, then per row this process's flash and paged launch counts so
    far, the call's wall clock (time.time()), the device-busy ms of the
    profiled call (NaN on the others) and the restore's span."""
    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.util import timeline

    cfg = LlamaConfig.llama3_8b()
    _predict_calls.append(len(_predict_calls) + 1)
    torch.cuda.synchronize()
    t0 = time.time()
    busy_ms = float("nan")
    if _predict_calls[-1] == PREDICT_PROFILED_CALL:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = score_rows(params, tokens, cfg)
            torch.cuda.synchronize()
        busy_ms = sum(r[1] for r in _device_kernels(prof, 1))
    else:
        out = score_rows(params, tokens, cfg)
    torch.cuda.synchronize()
    t1 = time.time()
    span = [e for e in timeline.timeline()
            if e["name"].startswith("ckpt_restore:")]
    B = tokens.shape[0]

    def col(value, dtype=torch.float64):
        return torch.full((B,), value, dtype=dtype)

    out.update(flash_fwd=col(fa.launches, torch.int64),
               paged_decode=col(pa.launches, torch.int64),
               t_start=col(t0), t_end=col(t1), busy_ms=col(busy_ms),
               restore_ts=col(span[0]["ts"] / 1e6 if span else np.nan),
               restore_s=col(span[0]["dur"] / 1e6 if span else np.nan))
    return out


def phase_batch_predict(card: str):
    """Phase 15b: llama3_8b at full width and depth scores a Dataset of
    token rows through BatchPredictor in one GPU actor, against the
    driver's own forward on the same rows."""
    import shutil

    import chip_smoke as cs
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.models import LlamaConfig, init_params, num_params
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train import BatchPredictor, Checkpoint, TorchPredictor

    c = PREDICT
    cfg = LlamaConfig.llama3_8b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    nbytes, n_params = tree_bytes(params), num_params(params)
    tokens = np.random.RandomState(c["seed"]).randint(
        0, cfg.vocab_size, (c["rows"], c["S"])).astype(np.int32)
    # The kernel at this path's shape against its plain version (these
    # launches are the driver's, not the actor's).
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    q, k, v = (torch.randn((c["batch"], c["S"], h, cfg.dh), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    o, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    ro, _ = fa.flash_attention_reference(q, k, v, causal=True)
    err = (o.float() - ro.float()).abs().max().item()
    del q, k, v, o, ro
    assert err <= 2e-2, err
    want = []
    t0 = time.perf_counter()
    for i in range(0, c["rows"], c["batch"]):
        x = torch.from_numpy(tokens[i:i + c["batch"]]).cuda()
        want.append({k: v.cpu().numpy()
                     for k, v in score_rows(params, x, cfg).items()})
    torch.cuda.synchronize()
    driver_s = time.perf_counter() - t0
    path = ckpt_dir("predict", nbytes, card)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck = Checkpoint.from_pytree(params, path)
        save_s = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        rt.init(num_cpus=2)
        try:
            ds = rd.from_numpy(tokens, column="tokens",
                               override_num_blocks=c["rows"] // c["batch"])
            scored = BatchPredictor(
                ck, TorchPredictor, apply_fn=cs.predict_score,
                input_column="tokens").predict(ds, concurrency=1,
                                               batch_size=c["batch"])
            t_submit = time.time()
            arrivals, blocks = [], []
            for b in scored.iter_batches(batch_size=None):
                arrivals.append(time.time())
                blocks.append(b)
        finally:
            rt.shutdown()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    got = {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
    ref = {k: np.concatenate([w[k] for w in want]) for k in want[0]}
    lp_err = float(np.abs(got["logprob"] - ref["logprob"]).max())
    bitwise = np.array_equal(got["logprob"], ref["logprob"])
    argmax_eq = np.array_equal(got["next_token"], ref["next_token"])
    launches = {"flash_fwd": int(got["flash_fwd"][-1]),
                "paged_decode": int(got["paged_decode"][-1])}
    calls = [(blocks[i]["t_start"][0], blocks[i]["t_end"][0])
             for i in range(len(blocks))]
    batch_ms = [float(e - s) * 1e3 for s, e in calls]
    gap_ms = [float(calls[i + 1][0] - calls[i][1]) * 1e3
              for i in range(len(calls) - 1)]
    restore_s = float(got["restore_s"][0])
    start_s = float(got["restore_ts"][0]) - t_submit
    # Steady: the blocks after the first, before the profiled last one.
    steady_s = arrivals[-2] - arrivals[0]
    steady_rows = c["rows"] - 2 * c["batch"]
    steady_ms = float(np.median(batch_ms[1:-1]))
    busy_ms = float(np.nanmax(got["busy_ms"]))
    log(f"[predict] llama3_8b ({n_params / 1e9:.3f} B "
        f"params, {cfg.num_layers} layers, bf16): BatchPredictor(ckpt, "
        f"TorchPredictor, apply_fn=chip_smoke.predict_score), "
        f"{c['rows']} seeded rows of {c['S']} tokens in "
        f"{len(blocks)} blocks, batch_size={c['batch']}, concurrency=1, "
        f"one GPU actor; save {nbytes / 1e9:.3f} GB in {save_s:.2f} s "
        f"({nbytes / save_s / 1e9:.3f} GB/s); on {card}")
    log(f"[predict] actor start (submit to the restore's start: worker "
        f"spawn, imports) {start_s:.2f} s; restore {restore_s:.2f} s "
        f"({nbytes / restore_s / 1e9:.3f} GB/s); first batch "
        f"{batch_ms[0]:.1f} ms in the actor, first rows at the driver "
        f"{arrivals[0] - t_submit:.2f} s after submit; steady {steady_rows} "
        f"rows in {steady_s:.3f} s: {steady_rows / steady_s:.2f} rows/s, "
        f"{steady_rows * c['S'] / steady_s:.0f} tokens/s (driver's own "
        f"forward, all 8 batches: {c['rows'] / driver_s:.2f} rows/s); "
        f"batch ms in the actor {[round(x, 1) for x in batch_ms]} (the "
        f"last profiled), the actor idle between calls (the pool's "
        f"round trip) {[round(x, 1) for x in gap_ms]} ms; the profiled "
        f"batch's device-busy {busy_ms:.1f} "
        f"ms: {busy_ms / steady_ms:.3f} of a steady batch's "
        f"{steady_ms:.1f} ms wall")
    log(f"[predict] against the driver's forward on the same rows: "
        f"argmax {'equal' if argmax_eq else 'DIFFERS'}, log-probabilities "
        f"max|d| {lp_err:.3e} (tol 1e-3, {'bitwise' if bitwise else 'not bitwise'}); "
        f"in row order; flash kernel B={c['batch']} "
        f"S={c['S']} against plain max|dO| {err:.3e} (tol 2e-2); launches in "
        f"the actor {launches}")
    assert argmax_eq and lp_err <= 1e-3, (argmax_eq, lp_err)
    want_fwd = cfg.num_layers * c["rows"] // c["batch"]
    assert launches == {"flash_fwd": want_fwd, "paged_decode": 0}, launches
    return launches


def trainer_data_loop():
    """Phase 15c's train loop: phase 14b's model and steps, the tokens read
    from the rank's Dataset shard onto its card."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import CompiledTrainStep

    assert train.get_device().type == "cuda"
    train_launches(reset=True)
    cfg = trainer_config()
    step = CompiledTrainStep(cfg, learning_rate=1e-3)
    params, opt = step.init(torch.Generator(device="cuda").manual_seed(0))
    batches = iter(train.get_dataset_shard("train").iter_torch_batches(
        batch_size=1))
    for i in range(TRAINER_STEPS):
        t0 = time.perf_counter()
        tokens = next(batches)["tokens"]
        next_us = (time.perf_counter() - t0) * 1e6
        assert tokens.is_cuda and tokens.dtype == torch.int32 and \
            tuple(tokens.shape) == (1, 2049), (tokens.device, tokens.shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens)
        loss = loss.item()
        train.report({"step": i, "loss": loss, "next_us": next_us,
                      "step_ms": (time.perf_counter() - t0) * 1e3,
                      **train_launches()})


def phase_trainer_data(card: str, trainer_launches):
    """Phase 15c: phase 14b's 2-layer 8B trained by TorchTrainer fed by a
    Dataset: the rank reads its rows through get_dataset_shard("train")
    .iter_torch_batches, against phase 14b's straight run of the same
    rows in the driver."""
    import shutil

    import chip_smoke as cs
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg = trainer_config()
    rows = np.concatenate([t.cpu().numpy() for t in trainer_tokens(cfg, "cpu")])
    path = ckpt_dir("trainer_data", 0, card)
    rt.init(num_cpus=2)
    try:
        t0 = time.perf_counter()
        result = TorchTrainer(
            cs.trainer_data_loop,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=path),
            datasets={"train": rd.from_numpy(rows, column="tokens",
                                             override_num_blocks=4)},
        ).fit()
        fit_s = time.perf_counter() - t0
    finally:
        rt.shutdown()
        shutil.rmtree(path, ignore_errors=True)
    assert result.error is None, result.error
    hist = result.metrics_history
    losses = [m["loss"] for m in hist]
    straight = TRAINER_STRAIGHT["losses"]
    launches = {k: hist[-1][k] for k in TRAIN_COUNTERS}
    # Phase 14b's worker counted two steps after its restart.
    want = {k: v * TRAINER_STEPS // 2 for k, v in trainer_launches.items()}
    worker_ms = [m["step_ms"] for m in hist]
    next_us = [m["next_us"] for m in hist]
    log(f"[trainer-data] TorchTrainer(use_gpu=True, datasets={{'train': "
        f"from_numpy of phase 14b's 4 rows}}), the rank reading "
        f"get_dataset_shard('train').iter_torch_batches(batch_size=1): fit "
        f"{fit_s:.2f} s; losses {losses} against the driver's {straight}: "
        f"{'identical' if losses == straight else 'DIFFER'}; worker launches "
        f"{launches} (want {want}); on {card}")
    log(f"[trainer-data] median steady step ms in the worker "
        f"{np.median(worker_ms[1:]):.3f} against the driver's "
        f"{np.median(TRAINER_STRAIGHT['ms'][1:]):.3f} (first steps, the "
        f"warm-up, left out: worker {worker_ms[0]:.1f}, driver "
        f"{TRAINER_STRAIGHT['ms'][0]:.1f}); host µs in next(): first "
        f"{next_us[0]:.0f} (the plan's first tasks), then "
        f"{[round(x) for x in next_us[1:]]}")
    assert losses == straight, (losses, straight)
    assert launches == want, (launches, want)
    return launches


# ------------------------------------------- serve's control plane (16)

SERVE_NOOP_CALLS = 100
RECOVERY_TIMEOUT_S = 240.0


class ServeProbeLLM(LLMDeployment):
    """Phase 16's deployment: LLMDeployment, timed while it builds, plus
    one probe of the replica's process."""

    def __init__(self, *args, **kwargs):
        self.init_ts = [time.time()]  # the constructor starts
        super().__init__(*args, **kwargs)
        torch.cuda.synchronize()
        self.init_ts.append(time.time())  # weights drawn, engine built

    def probe(self, reset: bool = False, digest: bool = False):
        """The flash and paged launch counters of this process (then set
        to 0 if ``reset``), its pid, the engine's decode steps and the
        constructor's times, with the weights' digest if asked."""
        from ray_tpu_torch.ops import flash_attention as fa
        from ray_tpu_torch.ops import paged_attention as pa

        out = {"flash_fwd": fa.launches, "paged_decode": pa.launches,
               "pid": os.getpid(), "init_ts": self.init_ts,
               "decode_steps": self.engine.stats()["decode_steps"]}
        if reset:
            fa.launches = pa.launches = 0
        if digest:
            out["digest"] = weight_digest(self.engine.params)
        return out


def serve_noop(_):
    return None


def sse_tokens(port: int, request, stamps):
    """POST /llm/stream: the tokens of one SSE response, each arrival's
    time appended to ``stamps``."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llm/stream",
        data=json.dumps(request).encode(),
        headers={"Content-Type": "application/json"})
    tokens = []
    with urllib.request.urlopen(req, timeout=600) as r:
        assert r.headers.get("Content-Type") == "text/event-stream"
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("event: error"):
                raise RuntimeError(f"SSE error frame: {line}")
            if line.startswith("data:"):
                item = json.loads(line[5:].strip())
                if item is not None:
                    stamps.append(time.perf_counter())
                    tokens.append(item["token"])
    return tokens


def at_once(fn, args_list):
    """``fn(*args)`` for each entry in a thread of its own, all at once;
    the results in order (a failure is raised)."""
    out = [None] * len(args_list)
    errors = []

    def one(i, args):
        try:
            out[i] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i, a))
               for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return out


def phase_serve_deploy(card: str):
    """Phase 16: the full-width 8B deployed as a GPU replica through
    ray_tpu_torch.serve, phase 5's requests through the handle, its
    streaming call and the proxy's SSE, a crash and its recovery, then
    shutdown."""
    import signal
    import socket
    import urllib.request

    import chip_smoke as cs  # the deployment travels as chip_smoke.<name>
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.runtime_context import current_runtime
    from ray_tpu_torch.models import LlamaConfig

    prompts, outs5 = SLICE["prompts"], SLICE["outs"]
    reqs = [{"prompt": p, "max_new_tokens": n}
            for p, n in zip(prompts, SERVE_NEW)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0, total = torch.cuda.mem_get_info()
    # A whole generation takes seconds, which the replica's AIMD limiter
    # reads as overload at the 2 s default floor: it shrinks its limit and
    # sheds the sixth concurrent request. The floor is an environment knob
    # that every process of the runtime reads.
    knob = "RAY_TPU_SERVE_AIMD_LATENCY_TARGET_S"
    old_knob = os.environ.get(knob)
    os.environ[knob] = "600"
    rt.init(num_cpus=2)
    try:
        serve.status()  # the controller first: the replica alone is timed
        workers = set(current_runtime().worker_pids())
        dep = serve.deployment(cs.ServeProbeLLM).options(
            name="llm", ray_actor_options={"num_gpus": 1,
                                           "max_concurrency": 8}).bind(
            LlamaConfig.llama3_8b(), seed=0, **SERVE_ENGINE)
        spawned = []

        def watch():  # the replica's is the one worker the deploy starts
            while not spawned and workers == set(
                    current_runtime().worker_pids()):
                time.sleep(0.005)
            spawned.append(time.time())

        watcher = threading.Thread(target=watch, daemon=True)
        t_submit = time.time()
        watcher.start()
        h = serve.run(dep)
        t_ready = time.time()
        spawned.append(t_ready)  # ends a watcher that saw no new worker
        watcher.join(timeout=10)
        spawn_ts = spawned[0]
        probe = h.options(method="probe")
        first = probe.remote(digest=True).result(timeout=600)
        same = [a == b for a, b in zip(first["digest"], SLICE["digest"])]
        log(f"[serve-deploy] serve.run of ServeProbeLLM(llama3_8b, seed=0, "
            f"{SERVE_ENGINE}) as a GPU replica (num_gpus=1, max_concurrency="
            f"8), worker pid {first['pid']}: submit to ready "
            f"{t_ready - t_submit:.2f} s (its worker process started "
            f"{spawn_ts - t_submit:.2f} s after submit, its imports until "
            f"the constructor {first['init_ts'][0] - spawn_ts:.2f} s, "
            f"weights drawn and engine built "
            f"{first['init_ts'][1] - first['init_ts'][0]:.2f} s, then to the"
            f" first ping {t_ready - first['init_ts'][1]:.2f} s); weights' "
            f"digest against phase 5's: {sum(same)} of {len(SLICE['digest'])}"
            f" tensors equal; on {card}")
        assert len(same) == len(SLICE["digest"]) == 12 and all(same), same

        cfg = LlamaConfig.llama3_8b()
        warm = np.random.RandomState(0).randint(0, cfg.vocab_size, 40)
        h.remote({"prompt": warm.tolist(), "max_new_tokens": 2}).result(
            timeout=600)
        probe.remote(reset=True).result(timeout=60)
        stream = h.options(method="stream")

        def handle_stream(req, stamps):
            t0 = time.perf_counter()
            stamps.append(t0)
            for item in stream.stream(req):
                stamps.append(time.perf_counter())
                yield item["token"]

        h_stamps = [[] for _ in reqs]
        t0 = time.perf_counter()
        h_outs = at_once(lambda r, st: list(handle_stream(r, st)),
                         list(zip(reqs, h_stamps)))
        h_wall = time.perf_counter() - t0
        mid = probe.remote().result(timeout=60)
        s_stamps = [[] for _ in reqs]
        t0 = time.perf_counter()
        s_outs = at_once(lambda r, st: (st.append(time.perf_counter()),
                                        sse_tokens(h.http_port, r, st))[1],
                         list(zip(reqs, s_stamps)))
        s_wall = time.perf_counter() - t0
        after_sse = probe.remote().result(timeout=60)
        r_outs = [f.result(timeout=600)["tokens"]
                  for f in [h.remote(r) for r in reqs[:2]]]
        launched = probe.remote().result(timeout=60)
        launches = {k: launched[k] for k in ("flash_fwd", "paged_decode")}

        def ttft_ms(stamps):
            return [round((st[1] - st[0]) * 1e3, 1) for st in stamps]

        dec_tokens = sum(len(o) - 1 for o in h_outs)
        t_dec0 = min(st[1] for st in h_stamps)
        t_dec1 = max(st[-1] for st in h_stamps)
        gaps = [b - a for st in s_stamps for a, b in zip(st[1:], st[2:])]
        s_steps = after_sse["decode_steps"] - mid["decode_steps"]
        s_dec = max(st[-1] for st in s_stamps) - min(st[1] for st in s_stamps)
        differ = {how: [i for i, (a, b) in enumerate(zip(o, outs5)) if a != b]
                  for how, o in (("stream", h_outs), ("sse", s_outs),
                                 ("remote", r_outs))}
        log(f"[serve-deploy] phase 5's six requests (prompts {SERVE_LENS}, "
            f"new {SERVE_NEW}) at once through the handle's streaming call: "
            f"{h_wall:.2f} s, TTFT ms {ttft_ms(h_stamps)}, {dec_tokens} "
            f"decode tokens at {dec_tokens / (t_dec1 - t_dec0):.1f} tok/s; "
            f"through SSE (POST /llm/stream): {s_wall:.2f} s, TTFT ms "
            f"{ttft_ms(s_stamps)}; phase 5's engine in the driver: TTFT ms "
            f"{[round(x, 1) for x in SLICE['ttft_ms']]}; on {card}")
        log(f"[serve-deploy] median gap between SSE tokens at the client "
            f"{np.median(gaps) * 1e3:.2f} ms; the replica's engine "
            f"{s_dec / s_steps * 1e3:.2f} ms per decode step over the SSE "
            f"run ({s_steps} steps), phase 5's in the driver "
            f"{SLICE['step_ms']:.2f} ms; on {card}")
        log(f"[serve-deploy] greedy tokens against phase 5's: stream "
            f"{6 - len(differ['stream'])} of 6, SSE {6 - len(differ['sse'])} "
            f"of 6, handle.remote {2 - len(differ['remote'])} of 2 identical "
            f"(differ: {differ}); launches in the replica {launches}")
        assert not any(differ.values()), (differ, h_outs, s_outs, r_outs)
        assert launches["flash_fwd"] > 0 and launches["paged_decode"] > 0, \
            launches

        noop = serve.run(serve.deployment(cs.serve_noop).bind(),
                         name="noop")
        noop.remote(None).result(timeout=60)

        def median_ms(fn, n=SERVE_NOOP_CALLS):
            fn()
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))

        def http_noop():
            req = urllib.request.Request(
                f"http://127.0.0.1:{h.http_port}/noop", data=b"null",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert json.loads(r.read()) == {"result": None}

        handle_ms = median_ms(lambda: noop.remote(None).result(timeout=60))
        http_ms = median_ms(http_noop)
        log(f"[serve-deploy] the serve plane's cost per request: median of "
            f"{SERVE_NOOP_CALLS} calls to a no-op CPU deployment "
            f"{handle_ms:.3f} ms through the handle, {http_ms:.3f} ms "
            f"through HTTP (host times, not held); on {card}")

        pid = launched["pid"]
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        attempts, errors = 0, []
        while True:
            attempts += 1
            stamps = [time.perf_counter()]
            try:
                got = list(handle_stream(reqs[0], stamps))
                break
            except Exception as e:  # noqa: BLE001 — retried until replaced
                errors.append(type(e).__name__)
                if time.perf_counter() - t_kill > RECOVERY_TIMEOUT_S:
                    raise
                time.sleep(0.5)
        recovery_s = stamps[1] - t_kill
        new_pid = probe.remote().result(timeout=60)["pid"]
        log(f"[serve-deploy] replica worker {pid} killed (SIGKILL): the "
            f"controller's health check replaced it (new worker {new_pid});"
            f" {attempts} attempts (failed: {errors}), first token "
            f"{recovery_s:.2f} s after the kill; tokens "
            f"{'identical to' if got == outs5[0] else 'DIFFER from'} phase "
            f"5's; on {card}")
        assert got == outs5[0] and new_pid != pid, (got, outs5[0], new_pid)

        port = h.http_port
        serve.shutdown()
        left = alive_pids([new_pid])
        try:
            socket.create_connection(("127.0.0.1", port), 2.0).close()
            port_open = True
        except OSError:
            port_open = False
        deadline = time.monotonic() + 30
        while True:
            free1 = torch.cuda.mem_get_info()[0]
            if free0 - free1 <= 2**30 or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        log(f"[serve-deploy] serve.shutdown(): replica worker alive after "
            f"{left}, proxy port {port} {'OPEN' if port_open else 'closed'}"
            f"; the card's free memory {free1 / 2**30:.2f} GiB against "
            f"{free0 / 2**30:.2f} GiB before the deploy (of "
            f"{total / 2**30:.2f} GiB); on {card}")
        assert not left and not port_open, (left, port_open)
        assert free0 - free1 <= 2**30, (free0, free1)
    finally:
        rt.shutdown()
        if old_knob is None:
            del os.environ[knob]
        else:
            os.environ[knob] = old_knob
    return launches


# ---------------------------------------- RLlib's online loops (17)
# The JAX tests' toy envs (tests/test_rllib_families*.py), at module level
# so that runner actors import them as chip_smoke.<name>.

class Sign:
    """Discrete toy: obs=[signal in {-1,+1}]; the action must match the
    sign (+1 reward, else -1); 30-step episodes."""

    def __init__(self):
        self.observation_space = Box(-1.0, 1.0, (1,))
        self.action_space = Discrete(2)
        self._rng = np.random.RandomState(0)
        self._t = 0

    def _obs(self):
        self._sig = float(self._rng.choice([-1.0, 1.0]))
        return np.asarray([self._sig], "float32")

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        want = 1 if self._sig > 0 else 0
        r = 1.0 if int(action) == want else -1.0
        self._t += 1
        return self._obs(), r, False, self._t >= 30, {}


class GoToZero:
    """1-D continuous toy: reward -|x + a|; the optimum is a = -x."""

    def __init__(self):
        self.observation_space = Box(-1.0, 1.0, (1,))
        self.action_space = Box(-1.0, 1.0, (1,))
        self._rng = np.random.RandomState(0)
        self._t = 0

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        self._x = self._rng.uniform(-1, 1, (1,)).astype("float32")
        return self._x, {}

    def step(self, action):
        r = -float(abs(self._x[0] + float(action[0])))
        self._t += 1
        self._x = self._rng.uniform(-1, 1, (1,)).astype("float32")
        return self._x, r, False, self._t >= 50, {}


class Memory:
    """POMDP: the cue is visible only at t=0; every later step rewards the
    action matching the remembered cue; 8-step episodes."""

    def __init__(self):
        self.observation_space = Box(-1.0, 1.0, (1,))
        self.action_space = Discrete(2)
        self._rng = np.random.RandomState(0)
        self._t = 0

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        self._cue = float(self._rng.choice([-1.0, 1.0]))
        return np.asarray([self._cue], "float32"), {}

    def step(self, action):
        want = 1 if self._cue > 0 else 0
        r = 1.0 if int(action) == want else -1.0
        self._t += 1
        return np.asarray([0.0], "float32"), r, False, self._t >= 8, {}


class Coop:
    """2-agent cooperative sign task with a joint bonus (QMIX's)."""

    def __init__(self):
        self._rng = np.random.RandomState(0)
        self._t = 0

    def _obs(self):
        self._sig = self._rng.choice([-1.0, 1.0], size=2)
        return {f"a{i}": np.asarray([self._sig[i]], "float32")
                for i in range(2)}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, actions):
        correct = [int(actions[f"a{i}"]) == (1 if self._sig[i] > 0 else 0)
                   for i in range(2)]
        team = float(sum(correct)) + (1.0 if all(correct) else 0.0)
        rew = {f"a{i}": team / 2.0 for i in range(2)}
        self._t += 1
        done = self._t >= 25
        return (self._obs(), rew, {"__all__": done}, {"__all__": False}, {})


class CoopPush:
    """2-agent continuous cooperation (MADDPG's): each agent outputs an
    action close to its own target; the reward is shared."""

    action_low = -np.ones(1, np.float32)
    action_high = np.ones(1, np.float32)

    def __init__(self):
        self._rng = np.random.RandomState(0)
        self._t = 0

    def _obs(self):
        self._targets = self._rng.uniform(-0.8, 0.8, 2)
        return {f"a{i}": np.asarray([self._targets[i]], "float32")
                for i in range(2)}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, actions):
        errs = [abs(float(actions[f"a{i}"][0]) - self._targets[i])
                for i in range(2)]
        team = -(errs[0] + errs[1])
        rew = {f"a{i}": team / 2.0 for i in range(2)}
        self._t += 1
        done = self._t >= 25
        return (self._obs(), rew, {"__all__": done}, {"__all__": False}, {})


class RecSys:
    """Toy recsys (SlateQ's): clicks follow a logit over the slate's
    alignment with a hidden taste; reward = the clicked item's
    alignment."""

    num_items = 12
    slate_size = 3

    def __init__(self):
        rng = np.random.RandomState(7)
        self.item_features = rng.randn(self.num_items, 4).astype("float32")
        self._rng = np.random.RandomState(0)
        self._t = 0

    def _user(self):
        taste = self._rng.randn(4)
        self._taste = (taste / np.linalg.norm(taste)).astype("float32")
        return self._taste

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        return self._user(), {}

    def step(self, slate):
        aligns = np.asarray([float(self.item_features[i] @ self._taste)
                             for i in slate])
        ex = np.exp(aligns - aligns.max())
        probs = ex / (ex.sum() + np.exp(-aligns.max()))
        u = self._rng.rand()
        acc = 0.0
        clicked, reward = -1, 0.0
        for j, p in enumerate(probs):
            acc += p
            if u < acc:
                clicked = int(slate[j])
                reward = float(aligns[j])
                break
        self._t += 1
        return self._user(), reward, False, self._t >= 20, \
            {"clicked": clicked}


def kernel_counts():
    """Every kernel's launch counter in this process."""
    from ray_tpu_torch.ops import paged_attention as pa

    return {**train_launches(), "paged_decode": pa.launches}


def new_pids(before):
    """The runtime's worker pids that are not in ``before``."""
    from ray_tpu_torch.core.runtime_context import current_runtime

    return sorted(set(current_runtime().worker_pids()) - set(before))


def worker_pids():
    from ray_tpu_torch.core.runtime_context import current_runtime

    return current_runtime().worker_pids()


def stop_and_check(algo, pids, what: str):
    """``algo.stop()``, then none of ``pids`` is alive or held by the
    runtime a moment later."""
    algo.stop()
    deadline = time.monotonic() + 10.0
    while True:
        left = alive_pids(pids) + [p for p in pids if p in worker_pids()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, (what, left)


def ready_s(actors, t0: float) -> float:
    """Seconds from ``t0`` until every actor answers its ping."""
    import ray_tpu_torch as rt

    rt.get([a.__rtpu_ping__.remote() for a in actors], timeout=300)
    return time.perf_counter() - t0


def rl_loop_ppo(card: str, device=None):
    """Phase 17a: PPOConfig().build() on CartPole through two CPU runner
    actors, the learner on the card in the driver, to
    tests/test_rllib.py:35-63's criteria; iteration 1's sampled actions
    bitwise equal to phase 12b's in-driver runners'. Returns the last
    batch, the final weights and the algorithm's config."""
    import chip_smoke as cs
    from ray_tpu_torch.rllib import PPOConfig, SampleBatch
    from ray_tpu_torch.rllib.sample_batch import ACTIONS

    c = (PPOConfig().environment(cs.CartPole)
         .env_runners(num_env_runners=2, rollout_fragment_length=256)
         .training(lr=3e-3, train_batch_size=512, minibatch_size=128,
                   num_epochs=6)
         .debugging(seed=0))
    before = worker_pids()
    t0 = time.perf_counter()
    algo = c.build(device=device)
    build_s = time.perf_counter() - t0
    pids = new_pids(before)
    start_s = ready_s(algo.runners, t0)
    assert algo.learner.device.type == (device or "cuda"), algo.device
    assert len(pids) == 2, pids
    sample_ms, learn_ms, actions, last = [], [], [], {}
    sample_all, update_epochs = algo.sample_all, algo.learner.update_epochs

    def timed_sample():
        t = time.perf_counter()
        out = sample_all()
        sample_ms.append((time.perf_counter() - t) * 1e3)
        last["batch"] = SampleBatch.concat(out)
        actions.append(last["batch"][ACTIONS])
        return out

    def timed_update(*args, **kwargs):
        t = time.perf_counter()
        out = update_epochs(*args, **kwargs)
        learn_ms.append((time.perf_counter() - t) * 1e3)
        return out

    algo.sample_all, algo.learner.update_epochs = timed_sample, timed_update
    first, best, rewards = None, 0.0, []
    try:
        for _ in range(25):
            result = algo.train()
            if first is None and result["episodes_total"] > 0:
                first = result["episode_reward_mean"]
            best = max(best, result["episode_reward_mean"])
            rewards.append(round(result["episode_reward_mean"], 1))
            if best > 80:
                break
        weights = algo.get_weights()
    finally:
        stop_and_check(algo, pids, "PPO")
    ref = RL_PPO_12B["actions"]
    same = 0
    while same < min(len(ref), len(actions)) and np.array_equal(
            ref[same], actions[same]):
        same += 1
    log(f"[rl-loops] PPOConfig().environment(CartPole)...build(): build() "
        f"{build_s:.2f} s (probe, 2 runner actors submitted, learner on "
        f"{algo.learner.device}), runners answering {start_s:.2f} s after "
        f"build() began; mean episode reward by iteration {rewards}; first "
        f"{first}, best {best:.1f} (need > 60 and > first + 30); sampled "
        f"actions bitwise equal to phase 12b's in the first {same} of "
        f"{min(len(ref), len(actions))} iterations both ran (need >= 1); "
        f"on {card}")
    log(f"[rl-loops] PPO sampling ms by iteration through the runner "
        f"actors {[round(x, 1) for x in sample_ms]} (median "
        f"{np.median(sample_ms):.1f}) against phase 12b's in the driver "
        f"{[round(x, 1) for x in RL_PPO_12B['sample_ms']]} (median "
        f"{np.median(RL_PPO_12B['sample_ms']):.1f}); update_epochs ms "
        f"median {np.median(learn_ms):.1f}; on {card}")
    assert first is not None and best > 60 and best > first + 30, (
        first, best, rewards)
    assert same >= 1, "iteration 1's actions differ from phase 12b's"
    return last["batch"], weights, c


def rl_loop_remote_learner(card: str, batch, weights, c, device=None):
    """Phase 17b: LearnerGroup(remote=True, {"num_gpus": 1}) in a GPU
    worker against a learner in the driver on the card, from 17a's final
    weights on its last batch: the same stats, then 20 updates each."""
    import functools

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import LearnerGroup, MLPPolicy, PPOLearner
    from ray_tpu_torch.rllib.sample_batch import (
        ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS)

    policy = MLPPolicy(CartPole.obs_dim, CartPole.num_actions,
                       c.hidden_size, c.seed)
    policy.set_weights(weights)
    factory = functools.partial(PPOLearner, policy, c.lr, c.clip_param,
                                c.vf_loss_coeff, c.entropy_coeff,
                                device=device)
    mb = {"obs": batch[OBS],
          "actions": np.asarray(batch[ACTIONS], np.int32),
          "old_logp": batch[LOGPS], "adv": batch[ADVANTAGES],
          "returns": batch[RETURNS]}
    before = worker_pids()
    t0 = time.perf_counter()
    group = LearnerGroup(factory, remote=True, ray_remote_args=(
        {"num_gpus": 1} if device is None else {}))
    try:
        pids = new_pids(before)
        remote = group.update(mb)
        start_s = time.perf_counter() - t0
        local = factory()
        assert local.device.type == (device or "cuda"), local.device
        want = local.update(mb)
        worst = max(abs(remote[k] - want[k]) for k in want)
        assert remote.keys() == want.keys() and worst <= 1e-6, (
            remote, want)
        assert rt.get(group.update_async(mb)).keys() == want.keys()

        def timed(fn, n=20):
            times = []
            for _ in range(n):
                t = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t) * 1e3)
            return float(np.median(times))

        remote_ms = timed(lambda: group.update(mb))
        local_ms = timed(lambda: local.update(mb))
    finally:
        group.shutdown()
    time.sleep(0.2)
    left = alive_pids(pids)
    agree = "equal to" if worst == 0 else f"within {worst:.1e} of"
    log(f"[rl-loops] LearnerGroup(remote=True, num_gpus=1): first update "
        f"{start_s:.2f} s after the group was made (the GPU worker's "
        f"start included); stats on 17a's last batch of {len(batch[OBS])} "
        f"rows from its final weights {agree} "
        f"the driver's learner on the card ({sorted(want)}); median of 20 "
        f"updates (stats read back) {remote_ms:.2f} ms through the actor "
        f"against {local_ms:.2f} ms in the driver; shutdown() left "
        f"{left} of the worker {pids} alive; on {card}")
    assert len(pids) == 1 and not left, (pids, left)


def rl_learn_sign(card: str, name: str, device=None):
    """Phase 17c: DD-PPO or A3C on the sign task with the JAX tests'
    settings (2 workers, fragments of 120, lr 5e-3), to their criteria."""
    import chip_smoke as cs
    import ray_tpu_torch as rt
    from ray_tpu_torch import rllib
    from ray_tpu_torch.train.optim import leaves

    cfg = (getattr(rllib, name + "Config")().environment(cs.Sign)
           .env_runners(num_env_runners=2, rollout_fragment_length=120)
           .training(lr=5e-3).debugging(seed=0))
    if name == "DDPPO":
        cfg.sgd_rounds_per_iteration, iters = 4, 15
    else:
        cfg.grads_per_iteration, iters = 6, 25
    before = worker_pids()
    t0 = time.perf_counter()
    algo = cfg.build(device=device)
    build_s = time.perf_counter() - t0
    pids = new_pids(before)
    start_s = ready_s(algo.workers, t0)
    best, rewards, train_ms = -31.0, [], []
    try:
        for _ in range(iters):
            t = time.perf_counter()
            result = algo.train()
            train_ms.append((time.perf_counter() - t) * 1e3)
            rewards.append(round(result["episode_reward_mean"], 1))
            if result["episodes_total"] > 0:
                best = max(best, result["episode_reward_mean"])
            if best > 24:
                break
        if name == "DDPPO":
            ws = rt.get([w.get_weights.remote() for w in algo.workers])
            apart = max(float(np.abs(a - b).max())
                        for a, b in zip(leaves(ws[0]), leaves(ws[1])))
            extra = (f"the two workers' weights apart by at most {apart:.1e}"
                     f" (need <= 1e-6)")
        else:
            assert algo.device.type == (device or "cuda"), algo.device
            extra = (f"parameter server on {algo.device}, "
                     f"{result['num_grads_applied']} gradients applied in "
                     f"the last iteration")
    finally:
        stop_and_check(algo, pids, name)
    log(f"[rl-loops] {name} on the sign task (2 workers x 120 steps, lr "
        f"5e-3): build() {build_s:.2f} s, workers answering {start_s:.2f} s;"
        f" mean episode reward by iteration {rewards}, best {best:.1f} "
        f"(need > 24 within {iters}); {extra}; train() median "
        f"{np.median(train_ms):.1f} ms; on {card}")
    assert best > 24, (name, best, rewards)
    if name == "DDPPO":
        assert apart <= 1e-6, apart
    else:
        assert result["num_grads_applied"] > 0, result


def rl_loop_configs():
    """The other online loops, each on its JAX test's env and settings
    (tests/test_rllib.py, tests/test_rllib_families*.py), the warm-up cut
    to one iteration's steps so that one train() updates."""
    import chip_smoke as cs
    from ray_tpu_torch import rllib as rl

    def two(cfg, env, fragment, **training):
        if env is not None:
            cfg.environment(env)
        return (cfg.env_runners(num_env_runners=2,
                                rollout_fragment_length=fragment)
                .training(**training).debugging(seed=0))

    box = dict(lr=3e-3, minibatch_size=128,
               num_steps_sampled_before_learning_starts=200)
    az = two(rl.AlphaZeroConfig(), None, 200, lr=3e-3, minibatch_size=128)
    az.num_simulations, az.games_per_iteration = 32, 10
    az.train_batches_per_iteration = 12
    return {
        "A2C": two(rl.A2CConfig(), cs.Sign, 120, lr=5e-3,
                   train_batch_size=240, minibatch_size=240),
        "PG": two(rl.PGConfig(), cs.Sign, 120, lr=5e-3,
                  train_batch_size=240, minibatch_size=240),
        "IMPALA": two(rl.IMPALAConfig(), cs.CartPole, 256, lr=2e-3,
                      entropy_coeff=0.02),
        "DQN": two(rl.DQNConfig(), cs.CartPole, 128, lr=1e-3,
                   minibatch_size=64, buffer_size=20_000,
                   num_steps_sampled_before_learning_starts=256,
                   target_network_update_freq=300,
                   num_updates_per_iteration=48, epsilon_timesteps=4_000,
                   prioritized_replay=True),
        "DDPG": two(rl.DDPGConfig(), cs.GoToZero, 100,
                    num_updates_per_iteration=60, exploration_noise=0.2,
                    **box),
        "TD3": two(rl.TD3Config(), cs.GoToZero, 100,
                   num_updates_per_iteration=60, exploration_noise=0.2,
                   **box),
        "SAC": two(rl.SACConfig(), cs.GoToZero, 100,
                   num_updates_per_iteration=40, **box),
        "R2D2": two(rl.R2D2Config(), cs.Memory, 96, lr=3e-3,
                    num_updates_per_iteration=24,
                    num_steps_sampled_before_learning_starts=192,
                    epsilon_timesteps=2500, seq_len=8,
                    target_network_update_freq=400),
        "RecurrentPPO": two(rl.RecurrentPPOConfig(), cs.Memory, 128,
                            lr=3e-3, minibatch_size=256, num_epochs=4,
                            seq_len=8),
        "QMIX": two(rl.QMIXConfig(), cs.Coop, 100,
                    num_updates_per_iteration=32, epsilon_timesteps=3000,
                    num_actions=2, **box),
        "MADDPG": two(rl.MADDPGConfig(), cs.CoopPush, 100,
                      num_updates_per_iteration=48, act_dim=1,
                      exploration_noise=0.3, **box),
        "SlateQ": two(rl.SlateQConfig(), cs.RecSys, 100,
                      num_updates_per_iteration=32, epsilon_timesteps=2000,
                      **box),
        "AlphaZero": az,
    }


# Each loop's train() keys, as the JAX package's loops return them (the
# CPU tests hold the port's against them, tests/test_torch_rllib_loops*.py).
_EP = ("episode_reward_mean", "episodes_total", "training_iteration")
_REPLAY = _EP + ("num_env_steps_sampled", "num_learner_updates")
RL_LOOP_KEYS = {
    "A2C": _EP + ("num_env_steps_sampled", "policy_loss", "vf_loss",
                  "entropy", "total_loss"),
    "PG": _EP + ("num_env_steps_sampled", "policy_loss", "total_loss"),
    "IMPALA": _EP + ("num_batches_consumed", "pg_loss", "vf_loss",
                     "entropy", "total_loss"),
    "DQN": _REPLAY + ("epsilon", "buffer_size", "loss"),
    "DDPG": _REPLAY + ("buffer_size", "critic_loss", "q_mean",
                       "total_loss", "actor_loss"),
    "TD3": _REPLAY + ("buffer_size", "critic_loss", "q1_mean",
                      "total_loss", "actor_loss"),
    "SAC": _REPLAY + ("buffer_size", "loss", "critic_loss", "actor_loss",
                      "alpha"),
    "R2D2": _REPLAY + ("epsilon", "loss"),
    "RecurrentPPO": _EP + ("num_env_steps_sampled", "loss"),
    "QMIX": _REPLAY + ("epsilon", "td_loss", "q_tot_mean", "total_loss"),
    "MADDPG": _REPLAY + ("critic_loss_0", "critic_loss_1", "actor_loss",
                         "critic_loss"),
    "SlateQ": _REPLAY + ("epsilon", "loss"),
    "AlphaZero": ("training_iteration", "num_positions", "new_positions",
                  "total_loss", "policy_loss", "value_loss"),
}


def rl_every_loop(card: str, device=None):
    """Phase 17d: every other online loop built at once (their runner
    workers start side by side), then one train() each with the learner
    on the card: the JAX loop's result keys, finite numbers, at least one
    update; each stop() ends its runners."""
    configs = rl_loop_configs()
    built = {}
    for name, cfg in configs.items():
        before = worker_pids()
        t0 = time.perf_counter()
        algo = cfg.build(device=device)
        built[name] = (algo, time.perf_counter() - t0, t0, new_pids(before))
    rows = []
    try:
        for name, (algo, build_s, t0, pids) in built.items():
            actors = getattr(algo, "runners", None) or algo.actors
            start_s = ready_s(actors, t0)
            assert algo.learner.device.type == (device or "cuda"), name
            t = time.perf_counter()
            result = algo.train()
            train_ms = (time.perf_counter() - t) * 1e3
            assert sorted(result) == sorted(RL_LOOP_KEYS[name]), (
                name, sorted(result))
            bad = {k: v for k, v in result.items()
                   if not np.isfinite(v)}
            assert not bad, (name, bad)
            updates = result.get("num_learner_updates",
                                 result.get("num_batches_consumed", 1))
            assert updates > 0 and len(pids) == 2, (name, result, pids)
            rows.append(f"{name} {build_s:.2f}/{start_s:.2f}/"
                        f"{train_ms:.0f}")
    finally:
        for name, (algo, _, _, pids) in built.items():
            stop_and_check(algo, pids, name)
    log(f"[rl-loops] one train() of each other loop, learner on the card, "
        f"2 runner actors each, all {len(built)} built first so their "
        f"workers start side by side: build() s / runners answering s "
        f"(from that build's start) / train() ms: " + ", ".join(rows)
        + f"; every result has the JAX loop's keys, finite, and updated; "
        f"after each stop() none of its runner workers is alive; on {card}")


def phase_rllib_loops(card: str, device=None):
    """Phase 17: RLlib's online loops on the port's runtime."""
    import ray_tpu_torch as rt

    kernels = kernel_counts()
    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    try:
        batch, weights, c = rl_loop_ppo(card, device)
        rl_loop_remote_learner(card, batch, weights, c, device)
        for name in ("DDPPO", "A3C"):
            rl_learn_sign(card, name, device)
        rl_every_loop(card, device)
        pids = worker_pids()
    finally:
        rt.shutdown()
    time.sleep(0.2)
    left = alive_pids(pids)
    after = kernel_counts()
    log(f"[rl-loops] shutdown(): {len(pids)} worker processes, alive "
        f"after: {left}; kernel launch counters before and after the "
        f"phase {kernels} -> {after}; phase 17 took "
        f"{time.perf_counter() - t0:.1f} s; on {card}")
    assert not left, left
    assert after == kernels, (kernels, after)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ray_tpu_torch  # noqa: F401 — fails outside a checkout

    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    phase_build()
    kern = phase_kernels()
    kern.update(phase_backward_kernels())
    phase_parity()
    phase_train_parity()
    phase_moe_parity()
    ring = {"ring": phase_ring(card)}
    phase_ep_blocks(card)
    serve, serve_ckpt = phase_slice(card)
    serve = {"serve": serve, "serve_moe": phase_slice_moe(card),
             "serve_ckpt": serve_ckpt}
    train = {"train": phase_train(card, mesh=True),
             "train_moe": phase_train_moe(card),
             "pipeline": phase_pipeline(card),
             "resume": phase_resume(card)}
    phase_resnet(card)
    phase_telemetry(card)
    phase_ingest(card)
    phase_rllib(card)
    phase_rllib_more(card)
    torch.cuda.empty_cache()  # phase 14's worker shares the card
    phase_runtime(card)
    train["trainer"] = phase_trainer(card)
    phase_data(card)
    predict = {"batch_predict": phase_batch_predict(card)}
    torch.cuda.empty_cache()
    train["trainer_data"] = phase_trainer_data(card, train["trainer"])
    torch.cuda.empty_cache()
    serve["serve_deploy"] = phase_serve_deploy(card)
    torch.cuda.empty_cache()
    phase_rllib_loops(card)
    src = "ray_tpu_torch/ops/csrc/"
    fa_src = "ray_tpu/ops/flash_attention.py:"
    attn = "H=32 Hkv=8 D=128 causal bf16"
    sdpa_bwd = "backward of F.scaled_dot_product_attention (dQ, dK, dV)"

    def launched(name, paths):
        by_path = {p: n[name] for p, n in paths.items()}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    kernels = [
        dict(name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
             replaces=fa_src + "40",
             **launched("flash_fwd", {**serve, **train, **ring, **predict}),
             shape="B=1 S=2048 " + attn, **kern["flash_fwd_S2048"]),
        dict(name="flash_bwd_dq", route="cuda", source=src + "flash_bwd.cu",
             replaces=fa_src + "144",
             **launched("flash_bwd_dq", {**train, **ring}),
             shape="B=1 S=2048 " + attn, library=sdpa_bwd,
             **kern["flash_bwd_dq_B1_S2048"]),
        dict(name="flash_bwd_dkv", route="cuda", source=src + "flash_bwd.cu",
             replaces=fa_src + "187",
             **launched("flash_bwd_dkv", {**train, **ring}),
             shape="B=8 S=512 KV-head grid " + attn, library=sdpa_bwd,
             **kern["flash_bwd_dkv_B8_S512"]),
        dict(name="flash_bwd_dkv_per_head", route="cuda",
             source=src + "flash_bwd.cu", replaces=fa_src + "344",
             **launched("flash_bwd_dkv_per_head", {**train, **ring}),
             shape="B=1 S=2048 per-query-head grid " + attn,
             library=sdpa_bwd, **kern["flash_bwd_dkv_per_head_B1_S2048"]),
        dict(name="paged_decode", route="cuda",
             source=src + "paged_decode.cu",
             replaces="ray_tpu/ops/paged_attention.py:28",
             **launched("paged_decode", serve), shape="B=8 H=32 Hkv=8 "
             "D=128 page=16 Pmax=32 bf16, warm L2", **kern["paged_decode_B8"]),
    ]
    assert all(k["launches"] > 0 for k in kernels), kernels
    log(f"[card] {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
