"""The port's multi-device dry run (counterpart of
``__graft_entry__.dryrun_multichip``): one training step of each parallel
path over a world of ``n`` ranks, on tiny shapes, with the JAX dry run's
configurations.

1. dense: the full ``CompiledTrainStep`` (loss, gradients, AdamW) of a
   2-layer float32 Llama under dp/fsdp/sp/tp from :func:`_axis_sizes`;
2. moe-ep: the same step of a 4-expert, top-2 MoE model under dp x ep=2;
3. pipeline: an Adam step of a 2-stage tanh pipeline (``pipeline_apply``,
   4 microbatches) under pp=2.

:func:`dryrun_multichip` runs it over the caller's ``torch.distributed``
world when there is one, else over a world of ``n`` processes that it
starts and stops; :func:`dryrun_rank` is one rank's part. The
JAX dry run's fourth part, ``_dryrun_framework`` (the same dense step in a
``JaxTrainer`` gang), is not here yet: the port's ``TorchTrainer`` gang
exists, and the part waits in ROADMAP Queue 1 item 3.

It runs on the cards unless the caller passes ``device="cpu"``: a world
of NCCL processes, one a card, or of gloo processes on the CPU.

Weights come from ``torch.Generator`` seeds (JAX's threefry draws cannot be
reproduced), tokens and inputs from numpy seeds.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..models.llama import LlamaConfig
from .mesh import make_mesh
from .pipeline import pipeline_apply

TIMEOUT = datetime.timedelta(seconds=120)


def _axis_sizes(n: int) -> Dict[str, int]:
    """Factorize n over (tp, sp, dp, fsdp), innermost-first, powers of two
    preferred; any residual odd factor lands on dp."""
    sizes = {"tp": 1, "sp": 1, "dp": 1, "fsdp": 1}
    order = ["tp", "sp", "dp", "fsdp"]
    rem = n
    i = 0
    while rem % 2 == 0 and rem > 1:
        sizes[order[i % len(order)]] *= 2
        rem //= 2
        i += 1
    sizes["dp"] *= rem
    return sizes


def dense_config() -> LlamaConfig:
    return LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                       num_layers=2, num_heads=4, num_kv_heads=4,
                       rope_theta=10_000.0, dtype=torch.float32)


def moe_config() -> LlamaConfig:
    return LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                       num_layers=2, num_heads=4, num_kv_heads=4,
                       rope_theta=10_000.0, dtype=torch.float32, n_experts=4,
                       top_k=2)


def dense_tokens(batch: int, seqlen: int, vocab: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(1).randint(
        0, vocab, (batch, seqlen + 1)))


def moe_tokens(dp: int, vocab: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(3).randint(
        0, vocab, (2 * dp, 17)))


def pipeline_inputs(n_stages: int):
    """(Ws [n_stages, 16, 16], bs [n_stages, 16], x [8, 16]), float32."""
    g = torch.Generator().manual_seed(4)
    Ws = torch.randn(n_stages, 16, 16, generator=g) * 0.1
    x = torch.from_numpy(np.random.RandomState(5).randn(8, 16).astype(
        np.float32))
    return Ws, torch.zeros(n_stages, 16), x


def pipeline_stage(p, h):
    W, b = p
    return torch.tanh(h @ W + b)


def _train_step(cfg, mesh, seed: int, global_tokens) -> float:
    from ..train import CompiledTrainStep

    step = CompiledTrainStep(cfg, mesh=mesh)
    params, opt_state = step.init(
        torch.Generator(device=mesh.device_type).manual_seed(seed))
    tokens = step.token_sharding().cut(global_tokens)
    loss = step(params, opt_state, tokens)[2].item()
    return loss


def _dryrun_dense(n: int, device: DeviceLike) -> float:
    ax = _axis_sizes(n)
    mesh = make_mesh(dp=ax["dp"], fsdp=ax["fsdp"], sp=ax["sp"], tp=ax["tp"],
                     device=device)
    cfg = dense_config()
    batch = max(ax["dp"] * ax["fsdp"], 2) * 2
    loss = _train_step(cfg, mesh, 0, dense_tokens(batch, 8 * ax["sp"],
                                                  cfg.vocab_size))
    if not np.isfinite(loss):
        raise RuntimeError(f"dense dryrun loss not finite: {loss}")
    _log(f"  dense dp={ax['dp']} fsdp={ax['fsdp']} sp={ax['sp']} "
         f"tp={ax['tp']}: loss={loss:.4f}")
    return loss


def _dryrun_moe_ep(n: int, device: DeviceLike) -> float:
    ep = 2 if n % 2 == 0 else 1
    dp = n // ep
    mesh = make_mesh(dp=dp, ep=ep, device=device)
    cfg = moe_config()
    loss = _train_step(cfg, mesh, 2, moe_tokens(dp, cfg.vocab_size))
    if not np.isfinite(loss):
        raise RuntimeError(f"moe dryrun loss not finite: {loss}")
    _log(f"  moe dp={dp} ep={ep}: loss={loss:.4f}")
    return loss


def _dryrun_pipeline(n: int, device: DeviceLike) -> Optional[float]:
    """The step on the first pp ranks (JAX's mesh takes the first pp
    devices); the other ranks build the mesh and return None."""
    from ..train.optim import AdamW

    pp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(dp=1, pp=pp, device=device)
    if mesh.get_coordinate() is None:
        return None
    stage = mesh.get_local_rank("pp")
    Ws, bs, x = (t.to(mesh.device_type) for t in pipeline_inputs(pp))
    params = {"W": Ws[stage:stage + 1].clone().requires_grad_(),
              "b": bs[stage:stage + 1].clone().requires_grad_()}
    out = pipeline_apply(lambda p, h: pipeline_stage((p["W"], p["b"]), h),
                         params, x, mesh, n_microbatches=4, remat=False)
    loss = (out ** 2).mean()
    (loss / mesh.size()).backward()
    grads = {k: v.grad for k, v in params.items()}
    params = {k: v.detach() for k, v in params.items()}
    opt = AdamW(1e-3, weight_decay=0.0)  # optax.adam(1e-3)
    opt.update(params, grads, opt.init(params))
    loss = loss.item()
    if not np.isfinite(loss):
        raise RuntimeError(f"pipeline dryrun loss not finite: {loss}")
    _log(f"  pipeline pp={pp}: loss={loss:.4f}")
    return loss


def _log(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def dryrun_rank(n: int, device: DeviceLike = None,
                ) -> Dict[str, Optional[float]]:
    """One rank's part of the dry run, inside an initialised world of
    ``n`` ranks (NCCL for the card, the default; gloo for
    ``device="cpu"``): {"dense", "moe", "pipeline"} losses (the
    pipeline's is None on ranks outside its mesh)."""
    out = {"dense": _dryrun_dense(n, device)}
    if n >= 2:
        out["moe"] = _dryrun_moe_ep(n, device)
        out["pipeline"] = _dryrun_pipeline(n, device)
    return out


def _rank_main(rank: int, n: int, device_type: str, store: str,
               results) -> None:
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=n, timeout=TIMEOUT)
    try:
        results.put((rank, dryrun_rank(n, device_type)))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     ) -> Dict[str, Optional[float]]:
    """Run the dry run over ``n_devices`` ranks and return rank 0's losses.
    By default on ``n_devices`` cards (raises with fewer), over NCCL;
    ``device="cpu"`` runs it on the CPU over gloo. It runs over the
    caller's world when ``torch.distributed`` is initialised (its size
    must be ``n_devices``), else over a world of ``n_devices`` processes
    (one a card), started here and stopped before returning."""
    device_type = resolve_device(device).type
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the world has {dist.get_world_size()} ranks, "
                             f"not {n_devices}")
        out = dryrun_rank(n_devices, device_type)
        _log(f"dryrun_multichip({n_devices}): OK")
        return out
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} cards asked for, "
                           f"{torch.cuda.device_count()} present; pass "
                           f"device='cpu' to run on the CPU")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n_devices, device_type, store, results))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        got = {}
        try:
            while len(got) < n_devices:
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError(
                        "a dry-run rank failed: exit codes "
                        f"{[p.exitcode for p in procs]}")
                try:
                    rank, losses = results.get(timeout=1)
                except queue.Empty:
                    continue
                got[rank] = losses
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    print(f"dryrun_multichip({n_devices}): OK", flush=True)
    return got[0]
