"""Llama-family transformer in PyTorch, dense or Mixtral-style MoE.

Counterpart of ``ray_tpu/models/llama.py``: the same config fields and
presets, and parameters as a dict with the same keys, shapes and layout as
the JAX ``init_params`` (``wq`` is [L, M, H, Dh], layers stacked on a
leading L axis), so a JAX tree loads 1:1 (``models/convert.py``). bf16
weights and activations with float32 RMSNorm, rope and SiLU, as in JAX.

Attention goes through the flash kernels (``ops/flash_attention.py``,
differentiable through the backward kernels) when ``cfg.use_flash`` is set,
else through plain ``mha_attention``. The layers run as a Python loop (the
JAX ``lax.scan``) over per-layer weights. Training (JAX ``:272-434``):
``remat_policy`` and ``scan_chunk`` through ``torch.utils.checkpoint``, the
chunked cross-entropy and ``causal_lm_loss``; :func:`trainable_leaves`
gives the backward per-layer leaves whose gradients land in one stacked
buffer. With ``n_experts > 0`` each block's feed-forward is the MoE layer
(``parallel/moe.py``, JAX ``:238-245``) and its aux loss is summed over the
layers.

Under a device mesh (``mesh=``, ``parallel/mesh.py``) every rank runs the
same code on its local shards (explicit SPMD; JAX leaves this to GSPMD).
:func:`param_logical_axes` and the rules (``parallel/sharding.py``) say
which slice of each weight a rank holds, and the model calls the
collectives at fixed points (:class:`MeshPlan`):
- ``fsdp`` (and any other axis a rule puts on a weight dim other than
  heads, MLP columns or vocabulary) is all-gathered per layer inside the
  remat'd region, so the recompute gathers again and the saved tensors
  stay sharded; the gather's backward reduce-scatters the gradient.
- ``tp`` (Megatron): local heads, MLP columns and vocabulary rows; an
  all-reduce after ``wo`` and after ``w_down``; the embedding is a masked
  lookup summed over ``tp``, and the loss takes its log-sum-exp and target
  logit across ``tp`` (no rank gathers the vocabulary).
- ``dp``/``fsdp`` split the batch and ``sp`` the sequence (rope positions
  are global); attention over a split sequence is the ring
  (``parallel/ring_attention.py``). The loss's sums are all-reduced over
  the data axes.
- ``ep`` splits the experts of an MoE layer: each rank keeps its
  [E/ep, M, F/tp] expert slices, routes over the global token axis as
  GSPMD does for JAX, runs its experts on its tokens and sums the partial
  outputs over ``ep`` and ``tp`` (``parallel/moe.py``). A rule that splits
  the tokens over an expert axis raises ``ValueError``.
- ``pp`` splits the stacked ``layers`` axis: each rank holds L/pp layers
  of every stacked leaf, and layer i's leaves are broadcast over ``pp``
  from the rank that holds it (packed into one call, but for leaves of
  ``collectives.PACK_BYTES`` or more), inside the remat'd region (before
  the ``fsdp`` gather), as GSPMD moves a layer to where it is needed;
  the broadcast's backward sums the gradient onto that rank. Every rank
  computes every layer. The GPipe schedule is ``parallel/pipeline.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from .._device import DeviceLike, index_like_jax, resolve_device
from ..ops.attention import mha_attention
from ..ops.flash_attention import flash_attention
from ..parallel import collectives as coll
from ..parallel.mesh import mesh_axis_size
from ..parallel.moe import moe_ffn, weight_axes as moe_weight_axes
from ..parallel.ring_attention import ring_attention
from ..parallel.sharding import (
    DEFAULT_RULES,
    NamedSharding,
    Rule,
    entry_axes,
    logical_to_spec,
    tree_map,
)

Params = Dict[str, Any]
Layer = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32_000
    hidden_size: int = 4096
    intermediate_size: int = 14_336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # MoE (Mixtral-style) when n_experts > 0.
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # Training fields, kept so a JAX config maps field for field; the
    # training slice reads them.
    remat: bool = True
    remat_policy: str = "full"
    use_flash: bool = True
    loss_chunk: int = 512
    scan_layers: bool = True
    scan_chunk: int = 0

    @property
    def dh(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=8192, intermediate_size=28_672, num_layers=80,
            num_heads=64, num_kv_heads=8,
        )

    @staticmethod
    def mixtral_8x7b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=4096, intermediate_size=14_336, num_layers=32,
            num_heads=32, num_kv_heads=8, n_experts=8, top_k=2,
        )

    @staticmethod
    def tiny(vocab: int = 256, moe: bool = False) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10_000.0,
            dtype=torch.float32, n_experts=4 if moe else 0, top_k=2,
        )


def param_shapes(cfg: LlamaConfig) -> Params:
    """Shape of every leaf, keyed as in ``init_params``. MoE layers hold a
    router [L, M, E] and experts [L, E, ...] (JAX ``:130-140``)."""
    M, Fd, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, Hkv, Dh, V = cfg.num_heads, cfg.num_kv_heads, cfg.dh, cfg.vocab_size
    layers = {
        "attn_norm": (L, M),
        "wq": (L, M, H, Dh),
        "wk": (L, M, Hkv, Dh),
        "wv": (L, M, Hkv, Dh),
        "wo": (L, H, Dh, M),
        "mlp_norm": (L, M),
    }
    if cfg.n_experts > 0:
        E = cfg.n_experts
        layers.update(router=(L, M, E), w_gate=(L, E, M, Fd),
                      w_up=(L, E, M, Fd), w_down=(L, E, Fd, M))
    else:
        layers.update(w_gate=(L, M, Fd), w_up=(L, M, Fd), w_down=(L, Fd, M))
    return {
        "embed": (V, M),
        "layers": layers,
        "final_norm": (M,),
        "lm_head": (M, V),
    }


def param_logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Logical axes of each parameter leaf (maps through DEFAULT_RULES:
    embed->fsdp, heads/mlp/vocab->tp, expert->ep, layers->pp); JAX
    ``:121-148``."""
    layer = {
        "attn_norm": ("layers", "norm"),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "mlp_norm": ("layers", "norm"),
    }
    if cfg.n_experts > 0:
        layer.update(
            router=("layers", "embed", None),
            w_gate=("layers", "expert", "embed", "mlp"),
            w_up=("layers", "expert", "embed", "mlp"),
            w_down=("layers", "expert", "mlp", "embed"),
        )
    else:
        layer.update(
            w_gate=("layers", "embed", "mlp"),
            w_up=("layers", "embed", "mlp"),
            w_down=("layers", "mlp", "embed"),
        )
    return {
        "embed": ("vocab", "embed"),
        "layers": layer,
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


# Logical axes whose weight dims stay split (Megatron tensor parallelism):
# the model computes on the local slice and reduces the result.
_LOCAL_AXES = frozenset({"heads", "kv_heads", "mlp", "vocab", "expert"})


class MeshPlan:
    """Where the model's collectives go under ``mesh`` and ``rules``: the
    spec of every leaf (unpruned, so an axis of size 1 is a group of one
    and the code is the same at any world size), the axes to all-reduce
    after the attention output and the MLP, the vocabulary's axes, and the
    data axes the batch and the sequence split over."""

    def __init__(self, cfg: LlamaConfig, mesh, rules: Sequence[Rule]):
        self.mesh = mesh
        self.rules = rules
        self.axes = param_logical_axes(cfg)
        self.specs = tree_map(lambda a: logical_to_spec(a, rules), self.axes)
        lay = self.specs["layers"]

        def same(*entries):
            if len(set(entries)) != 1:
                raise ValueError(f"rules split matching dims differently: "
                                 f"{entries}")
            return entry_axes(entries[0])

        self.heads = same(lay["wq"][2], lay["wk"][2], lay["wv"][2],
                          lay["wo"][1])
        mlp_dim = 3 if cfg.n_experts > 0 else 2
        self.mlp = same(lay["w_gate"][mlp_dim], lay["w_up"][mlp_dim],
                        lay["w_down"][mlp_dim - 1])
        self.layers = same(*(s[0] for s in lay.values()))
        n = 1
        for a in self.layers:
            n *= mesh_axis_size(mesh, a)
        if cfg.num_layers % n:
            raise ValueError(f"{cfg.num_layers} layers do not split into {n} "
                             f"pipeline pieces")
        self.local_layers = cfg.num_layers // n
        self.vocab = same(self.specs["embed"][0], self.specs["lm_head"][1])
        batch, seq = logical_to_spec(("batch", "seq"), rules)
        self.batch, self.seq = entry_axes(batch), entry_axes(seq)
        if mesh_axis_size(mesh, "sp") > 1 and self.seq != ("sp",):
            raise ValueError("sequence parallelism needs the rule seq -> sp")
        self.data = self.batch + self.seq
        clash = set(self.data) & set(self.heads + self.mlp + self.vocab)
        if clash:
            raise ValueError(f"mesh axes {sorted(clash)} split both the data "
                             f"and the weights' model-parallel dims")
        if cfg.n_experts > 0:
            moe_weight_axes(rules)  # raises on a data axis over the experts
        self.tokens = NamedSharding(mesh, (batch, seq))

    def layer(self, i: int, lp: Layer) -> Layer:
        """Global layer ``i``'s weights, for this rank's compute: the
        layer's leaves broadcast over the ``layers`` axes from the rank
        that holds the layer (:func:`collectives.broadcast_flat`; ``lp``
        is this rank's local layer ``i % local_layers``, whose value only
        the holder sends), then each gathered as :meth:`gather` says."""
        if self.layers:
            lp = dict(zip(lp, coll.broadcast_flat(
                lp.values(), self.layers, i // self.local_layers,
                mesh=self.mesh)))
        return {k: self.gather(f"layers.{k}", w) for k, w in lp.items()}

    def gather(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Leaf ``name`` ("embed", or "layers.wq" for one layer's slice)
        with every split dim gathered except its heads, MLP columns and
        vocabulary."""
        if name.startswith("layers."):
            key = name[len("layers."):]
            logical = self.axes["layers"][key][1:]
            spec = self.specs["layers"][key][1:]
        else:
            logical, spec = self.axes[name], self.specs[name]
        for dim, (axis, entry) in enumerate(zip(logical, spec)):
            if entry is not None and axis not in _LOCAL_AXES:
                x = coll.allgather(x, entry, gather_dim=dim, mesh=self.mesh)
        return x

    def reduce(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        return coll.allreduce(x, axes, mesh=self.mesh) if axes else x

    def vocab_start(self, n_local: int) -> int:
        """The first id of this rank's ``n_local`` vocabulary rows."""
        if not self.vocab:
            return 0
        return coll.axis_index(self.vocab, mesh=self.mesh) * n_local

    def seq_offset(self, local_len: int) -> int:
        """Global position of this rank's first token."""
        return self.tokens.coords(1)[0] * local_len

    def data_shards(self) -> int:
        return self.tokens.coords(0)[1] * self.tokens.coords(1)[1]


def _plan(cfg: LlamaConfig, mesh, rules) -> Optional[MeshPlan]:
    return None if mesh is None else MeshPlan(cfg, mesh, rules)


def _is_norm(name: str) -> bool:
    return name.endswith("norm")


def leaf_dtype(cfg: LlamaConfig, name: str) -> torch.dtype:
    """The dtype of leaf ``name`` (``"embed"``, ``"layers.router"``, ...):
    float32 for the norms and the MoE router, ``cfg.dtype`` for the rest,
    as in JAX's ``init_params``."""
    if _is_norm(name) or name.endswith("router"):
        return torch.float32
    return cfg.dtype


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, *,
                shard: Optional[Callable[[str, torch.Tensor],
                                         torch.Tensor]] = None,
                layers: Optional[range] = None) -> Params:
    """Random weights drawn on ``device`` from ``generator`` (a generator
    on that device; default: one seeded with 0). Matrices are normal with
    std fan_in ** -0.5 in ``cfg.dtype``; norms are float32 ones, and the
    MoE router is drawn in ``cfg.dtype`` and widened to float32, as in
    JAX. Stacked leaves are drawn one layer at a time, so the float32 draw
    never holds a whole stacked leaf.

    ``shard(name, tensor)`` keeps a piece of each draw: of one layer's
    slice of a stacked leaf (name "layers.wq"), or of a whole top-level
    leaf ("embed"). ``layers`` (a range of layer indices) keeps only those
    layers of each stacked leaf (a rank's pipeline piece). The draws are
    the same with or without them, so a sharded init holds the slices of
    the unsharded one."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cut = shard or (lambda name, t: t)
    shapes = param_shapes(cfg)
    fan_in = {"wq": cfg.hidden_size, "wk": cfg.hidden_size,
              "wv": cfg.hidden_size, "wo": cfg.num_heads * cfg.dh,
              "w_gate": cfg.hidden_size, "w_up": cfg.hidden_size,
              "w_down": cfg.intermediate_size, "router": cfg.hidden_size}

    def draw(shape, fan):
        d = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (d * fan ** -0.5).to(cfg.dtype)

    def winit(shape, fan):  # row by row, as the stacked leaves
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for i in range(shape[0]):
            out[i] = draw(shape[1:], fan)
        return out

    kept = range(cfg.num_layers) if layers is None else layers
    stack = {}
    for name, shape in shapes["layers"].items():
        dtype = leaf_dtype(cfg, name)
        out = None
        for i in range(shape[0]):
            if _is_norm(name):
                full = torch.ones(shape[1:], dtype=dtype, device=dev)
            else:
                full = draw(shape[1:], fan_in[name]).to(dtype)
            if i not in kept:
                continue
            piece = cut(f"layers.{name}", full)
            if out is None:
                out = torch.empty((len(kept),) + tuple(piece.shape),
                                  dtype=dtype, device=dev)
            out[i - kept.start] = piece
        stack[name] = out
    M = cfg.hidden_size
    return {
        "embed": cut("embed", winit(shapes["embed"], M)).contiguous(),
        "layers": stack,
        "final_norm": cut("final_norm", torch.ones(
            (M,), dtype=torch.float32, device=dev)).contiguous(),
        "lm_head": cut("lm_head", winit(shapes["lm_head"], M)).contiguous(),
    }


def layer_params(params: Params, i: int) -> Layer:
    """Layer i's weights: views into the stacked leaves (no copy)."""
    return {k: v[i] for k, v in params["layers"].items()}


def trainable_leaves(params: Params,
                     grads: Params) -> Tuple[Params, List[Layer]]:
    """Leaves for a backward pass: (top, layers), where ``top`` holds
    embed/final_norm/lm_head and ``layers[i]`` layer i's weights, each a
    leaf that requires grad and shares storage with ``params``, its
    ``.grad`` preset to the matching view of ``grads`` (zeros, same tree).
    The backward then accumulates every gradient in place into ``grads``'s
    stacked buffers.

    Views ``stacked[i]`` that require grad would give each layer's
    backward a ``select_backward``, which allocates a zero tensor of the
    whole stack and adds it into the stack's gradient: at 8B, 32 times
    13.96 GB of traffic per step and two 3.8 GB transients."""

    def leaf(t, g):
        out = t.detach().requires_grad_()
        out.grad = g
        return out

    top = {k: leaf(params[k], grads[k])
           for k in ("embed", "final_norm", "lm_head")}
    layers = [{k: leaf(v[i], grads["layers"][k][i])
               for k, v in params["layers"].items()}
              for i in range(next(iter(params["layers"].values())).shape[0])]
    return top, layers


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved). x [B, S, H, D];
    positions [S] shared by every row, or [B, S] per row (the JAX decode
    path's vmap over rows)."""
    D = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, D // 2, dtype=torch.float32, device=x.device)
        / (D // 2))
    angles = positions.to(torch.float32)[..., None] * freqs  # [.., S, D/2]
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def project_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsm,mhd->bshd') as one matmul."""
    B, S, M = h.shape
    _, Hh, Dh = w.shape
    return (h @ w.reshape(M, Hh * Dh)).view(B, S, Hh, Dh)


def project_out(attn: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshd,hdm->bsm') as one matmul."""
    B, S, H, Dh = attn.shape
    return attn.reshape(B, S, H * Dh) @ wo.reshape(H * Dh, -1)


_names = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Names the products computed inside, for the ``"mlp"`` remat policy
    (JAX ``checkpoint_name``)."""
    outer = getattr(_names, "current", None)
    _names.current = name
    try:
        yield
    finally:
        _names.current = outer


def mlp(h: torch.Tensor, lp: Layer) -> torch.Tensor:
    """SwiGLU feed-forward; SiLU in float32, then cast (JAX ``:254``)."""
    with checkpoint_name("mlp_up"):
        up = h @ lp["w_up"]
    with checkpoint_name("mlp_gate"):
        gate = h @ lp["w_gate"]
    return (F.silu(gate.float()).to(up.dtype) * up) @ lp["w_down"]


def _attention(cfg: LlamaConfig, q, k, v, plan: Optional[MeshPlan] = None):
    if plan is not None and mesh_axis_size(plan.mesh, "sp") > 1:
        return ring_attention(q, k, v, plan.mesh, causal=True)
    if cfg.use_flash:
        return flash_attention(q, k, v, causal=True)
    return mha_attention(q, k, v, causal=True)


def ffn(cfg: LlamaConfig, h: torch.Tensor, lp: Layer,
        token_mask: Optional[torch.Tensor] = None,
        plan: Optional[MeshPlan] = None):
    """The block's feed-forward on normed ``h``: (out, aux), the MoE layer
    and its aux loss when ``cfg.n_experts > 0`` (rows with ``token_mask``
    0 routed nowhere), else the dense MLP and None. No MoE product is
    named, so the "mlp" remat policy saves nothing in MoE layers, as in
    JAX. Under a mesh the output is summed over the MLP's tensor-parallel
    axes (and for MoE over the expert axes, inside ``moe_ffn``)."""
    if cfg.n_experts > 0:
        return moe_ffn(h, lp["router"], lp["w_up"], lp["w_down"],
                       k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       w_gate=lp["w_gate"], token_mask=token_mask,
                       mesh=None if plan is None else plan.mesh,
                       rules=DEFAULT_RULES if plan is None else plan.rules)
    out = mlp(h, lp)
    return (out if plan is None else plan.reduce(out, plan.mlp)), None


def _layer(cfg: LlamaConfig, positions, x, lp,
           plan: Optional[MeshPlan] = None, index: int = 0):
    """One transformer block. x [B, S, M]. Returns (x, the MoE aux loss or
    None for a dense block). Under a mesh ``lp`` holds local shards of
    this rank's layer ``index % plan.local_layers``: the block fetches
    global layer ``index`` (:meth:`MeshPlan.layer`), and reduces the
    attention output and the feed-forward over their tensor-parallel
    axes."""
    if plan is not None:
        lp = plan.layer(index, lp)
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = rope(project_heads(h, lp["wq"]), positions, cfg.rope_theta)
    k = rope(project_heads(h, lp["wk"]), positions, cfg.rope_theta)
    v = project_heads(h, lp["wv"])
    attn = project_out(_attention(cfg, q, k, v, plan), lp["wo"])
    x = x + (attn if plan is None else plan.reduce(attn, plan.heads))
    out, aux = ffn(cfg, rms_norm(x, lp["mlp_norm"], cfg.rms_eps), lp,
                   plan=plan)
    return x + out, aux


def embed(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
          plan: Optional[MeshPlan] = None):
    """Token embeddings; out-of-range ids index as a JAX gather does.
    Under a mesh each rank looks up the ids in its vocabulary rows (zeros
    elsewhere) and the rows are summed over the vocabulary's axes."""
    if plan is None:
        ids = index_like_jax(tokens.long(), params["embed"].shape[0])
        return params["embed"][ids].to(cfg.dtype)
    ids = index_like_jax(tokens.long(), cfg.vocab_size)
    w = plan.gather("embed", params["embed"])
    n = w.shape[0]
    local = ids - plan.vocab_start(n)
    inside = (local >= 0) & (local < n)
    x = w[local.clamp(0, n - 1)] * inside[..., None]
    return plan.reduce(x.to(cfg.dtype), plan.vocab)


_MATMULS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
})
_MLP_NAMES = frozenset({"mlp_up", "mlp_gate"})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_mlp(ctx, op, *args, **kwargs):
    if op in _MATMULS and getattr(_names, "current", None) in _MLP_NAMES:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_context_fn(cfg: LlamaConfig):
    """The ``context_fn`` for ``torch.utils.checkpoint`` that
    ``cfg.remat_policy`` selects (JAX ``remat_policy``): "dots" saves every
    matmul output, "mlp" only the MLP up/gate products, anything else
    ("full") nothing but the checkpoint's inputs. "save_all" takes no
    checkpoint at all (see :func:`hidden_forward`)."""
    policy = {"dots": _save_dots, "mlp": _save_mlp}.get(cfg.remat_policy)
    if policy is None:
        return noop_context_fn
    return lambda: create_selective_checkpoint_contexts(policy)


def scan_chunks(cfg: LlamaConfig) -> Tuple[int, int]:
    """(layers_per_chunk, num_chunks) for the layer schedule; scan_chunk
    must divide num_layers (JAX ``scan_chunks``)."""
    K = max(1, cfg.scan_chunk or 1)
    if cfg.num_layers % K:
        raise ValueError(
            f"scan_chunk={K} must divide num_layers={cfg.num_layers}"
        )
    return K, cfg.num_layers // K


def _run_layers(cfg: LlamaConfig, positions, x,
                layers: List[Tuple[int, Layer]],
                plan: Optional[MeshPlan] = None):
    """Runs ``layers``, (global index, weights) pairs: (x after them,
    their MoE aux losses summed, or None when the blocks are dense). The
    aux leaves a checkpointed chunk as an output, so the router gets its
    gradient through it."""
    auxes = []
    for i, lp in layers:
        x, aux = _layer(cfg, positions, x, lp, plan, i)
        if aux is not None:
            auxes.append(aux)
    return x, (sum(auxes) if auxes else None)


def hidden_forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   layers: Optional[List[Layer]] = None, *, mesh=None,
                   rules: Sequence[Rule] = DEFAULT_RULES,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transformer trunk without the lm_head: (hidden [B, S, M] after
    final_norm, moe_aux_loss scalar — 0 for the dense model). ``layers``
    overrides the per-layer weights (default: views of the stacked
    leaves; :func:`trainable_leaves` for a backward pass). Under ``mesh``
    the params are this rank's shards under ``rules`` (its L/pp layers of
    the stack) and ``tokens`` its [B/(dp*fsdp), S/sp] piece; so is the
    hidden state it returns.

    While autograd records, with ``cfg.remat`` and a policy other than
    "save_all", each run of K layers (K from ``scan_chunk`` under
    ``scan_layers``, else 1) runs inside one ``torch.utils.checkpoint``
    (non-reentrant), as JAX puts one ``jax.checkpoint`` around each scan
    step. The loop is JAX's scan, so ``scan_layers`` changes nothing
    numerically."""
    B, S = tokens.shape
    plan = _plan(cfg, mesh, rules)
    x = embed(params, tokens, cfg, plan)
    positions = torch.arange(S, device=x.device)
    if plan is not None:
        positions = positions + plan.seq_offset(S)
    if layers is None:
        layers = [layer_params(params, i)
                  for i in range(next(iter(params["layers"].values()))
                                 .shape[0])]
    held = cfg.num_layers if plan is None else plan.local_layers
    if len(layers) != held:
        raise ValueError(f"{len(layers)} layers given; this rank holds "
                         f"{held} of {cfg.num_layers}")
    layers = [(i, layers[i % held]) for i in range(cfg.num_layers)]
    K = scan_chunks(cfg)[0] if cfg.scan_layers else 1
    remat = (cfg.remat and cfg.remat_policy != "save_all"
             and torch.is_grad_enabled())
    context_fn = remat_context_fn(cfg)
    auxes = []
    for c in range(0, cfg.num_layers, K):
        chunk = layers[c:c + K]
        if remat:
            x, aux = checkpoint(_run_layers, cfg, positions, x, chunk, plan,
                                use_reentrant=False, context_fn=context_fn)
        else:
            x, aux = _run_layers(cfg, positions, x, chunk, plan)
        if aux is not None:
            auxes.append(aux)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if not auxes:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, sum(auxes)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            layers: Optional[List[Layer]] = None, *, mesh=None,
            rules: Sequence[Rule] = DEFAULT_RULES,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B, S, V] float32, moe_aux_loss scalar). Under
    ``mesh`` the logits are this rank's [B/(dp*fsdp), S/sp, V/tp] piece."""
    x, aux = hidden_forward(params, tokens, cfg, layers, mesh=mesh,
                            rules=rules)
    plan = _plan(cfg, mesh, rules)
    lm_head = params["lm_head"] if plan is None else plan.gather(
        "lm_head", params["lm_head"])
    return (x @ lm_head).float(), aux


def _nll_sum(x: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor,
             plan: Optional[MeshPlan] = None) -> torch.Tensor:
    """Summed NLL of ``targets``. Under a mesh ``lm_head`` holds this rank's
    vocabulary columns: the log-sum-exp and the target logit are combined
    across the vocabulary's axes (a group of one gives the local values
    unchanged)."""
    logits = (x @ lm_head).float()
    lse = torch.logsumexp(logits, dim=-1)
    if plan is None:
        tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
        return (lse - tgt).sum()
    n = lm_head.shape[1]
    if plan.vocab:
        top = coll.allreduce(lse.detach(), plan.vocab, "max", mesh=plan.mesh)
        lse = top + torch.log(plan.reduce(torch.exp(lse - top), plan.vocab))
    local = targets.long() - plan.vocab_start(n)
    inside = (local >= 0) & (local < n)
    tgt = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    tgt = plan.reduce(tgt * inside, plan.vocab)
    return (lse - tgt).sum()


def _chunked_nll_sum(x: torch.Tensor, lm_head: torch.Tensor,
                     targets: torch.Tensor, chunk: int,
                     plan: Optional[MeshPlan] = None) -> torch.Tensor:
    """Total next-token NLL over [B, S] positions, streaming the lm_head
    projection and log-sum-exp over S/chunk slices, so no [B, S, V] tensor
    materializes; each slice is recomputed in the backward (JAX
    ``_chunked_nll_sum``, whose padded tail adds 0)."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, x.shape[1], chunk):
        args = (x[:, c0:c0 + chunk], lm_head, targets[:, c0:c0 + chunk],
                plan)
        if torch.is_grad_enabled():
            total = total + checkpoint(_nll_sum, *args, use_reentrant=False)
        else:
            total = total + _nll_sum(*args)
    return total


def causal_lm_loss(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   *, aux_weight: float = 0.01,
                   layers: Optional[List[Layer]] = None, mesh=None,
                   rules: Sequence[Rule] = DEFAULT_RULES) -> torch.Tensor:
    """Next-token cross entropy (tokens [B, S+1], shifted here). With
    cfg.loss_chunk > 0 and more targets than a chunk, the head projection
    and softmax stream over sequence chunks (JAX ``causal_lm_loss``).

    Under ``mesh``, ``tokens`` is this rank's window of the global batch
    (``CompiledTrainStep.token_sharding``): [B/(dp*fsdp), S/sp + 1], its
    last token the next window's first, so the targets are the global
    shift's. Every rank returns the global mean: the NLL sums are
    all-reduced over the data axes and divided by the global count."""
    targets = tokens[:, 1:]
    chunk = cfg.loss_chunk
    if mesh is not None:
        plan = MeshPlan(cfg, mesh, rules)
        x, aux = hidden_forward(params, tokens[:, :-1], cfg, layers,
                                mesh=mesh, rules=rules)
        lm_head = plan.gather("lm_head", params["lm_head"])
        if chunk and chunk > 0 and targets.shape[1] > chunk:
            total = _chunked_nll_sum(x, lm_head, targets, chunk, plan)
        else:
            total = _nll_sum(x, lm_head, targets, plan)
        total = plan.reduce(total, plan.data)
        return (total / (targets.numel() * plan.data_shards())
                + aux_weight * aux)
    if chunk and chunk > 0 and targets.shape[1] > chunk:
        x, aux = hidden_forward(params, tokens[:, :-1], cfg, layers)
        total = _chunked_nll_sum(x, params["lm_head"], targets, chunk)
        return total / targets.numel() + aux_weight * aux
    logits, aux = forward(params, tokens[:, :-1], cfg, layers)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return nll.mean() + aux_weight * aux


def num_params(params: Params) -> int:
    return sum(p.numel() for p in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "lm_head"))
