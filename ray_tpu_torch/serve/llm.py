"""Continuous-batched LLM serving with a paged KV cache, on the H100.

Counterpart of ``ray_tpu/serve/llm.py``: requests join and leave a running
decode loop; each decode step batches every active slot into one [B, 1]
forward pass, and prefill runs per admission into power-of-two length
buckets. KV memory is paged (``models/generation.py`` PagedKVCache): a
request reserves only the pages its prompt and max_new_tokens need, pages
recycle when it finishes, and admission waits for pages instead of running
out of memory.

The pool is written in place. A step that raises may leave it half
written, so the engine rebuilds it and fails the requests in flight
(``_reset_cache``), as the JAX engine does for a donated buffer.

Both steps run through ``util/device_metrics.instrumented_step``, as the
JAX engine's run through ``instrumented_jit``: a new signature counts as a
compile (``ray_tpu_device_jit_compiles_total{fn="decode_step"|"prefill"}``),
the decode step keyed by its batch shape and prefill by its bucket. The
decode step's tap rides a ring of 64 steps, flushed when the loop goes
idle, in ``stats()`` and at ``shutdown()``.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..models.generation import (
    PagedKVCache,
    check_params_device,
    paged_decode,
    paged_prefill,
    sample_logits,
)
from ..models.convert import params_from_numpy
from ..models.llama import LlamaConfig, init_params
from ..train.checkpoint import Checkpoint
from ..util.device_metrics import instrumented_step


class _Request:
    def __init__(self, prompt: List[int], max_new_tokens: int,
                 eos_token: Optional[int]):
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.eos_token = eos_token
        self.output: List[int] = []
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.ttft_s: Optional[float] = None
        self._t0: Optional[float] = None
        # Incremental consumers (token streaming) read from here; None is
        # the end-of-stream sentinel.
        self._live: "queue.Queue[Optional[int]]" = queue.Queue()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if self.error:
            raise self.error
        return self.output

    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield tokens as the decode loop produces them."""
        while True:
            tok = self._live.get(timeout=timeout)
            if tok is None:
                if self.error:
                    raise self.error
                return
            yield tok


class LLMEngine:
    """Paged continuous-batching decode engine over the Llama family, dense
    or MoE.

    ``params`` must already be on ``device`` (default: the CUDA card;
    ``device="cpu"`` runs on the CPU). ``seed`` seeds the sampling
    generator."""

    def __init__(self, cfg: LlamaConfig, params, *, max_batch: int = 8,
                 max_len: int = 512, temperature: float = 0.0,
                 page_size: int = 16, total_pages: Optional[int] = None,
                 device: DeviceLike = None, seed: int = 0):
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        if max_len % page_size != 0:
            # paged_prefill reshapes bucket rows into whole pages.
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({page_size})"
            )
        self.page_size = page_size
        self.max_pages_per_seq = math.ceil(max_len / page_size)
        # Default pool: enough for every slot at max_len (the same worst
        # case as a dense cache); pass a smaller total_pages to oversubscribe.
        self.total_pages = total_pages or (
            max_batch * self.max_pages_per_seq
        )
        self.cache = self._new_cache()
        self._free_pages: List[int] = list(range(self.total_pages))
        self._table = np.zeros(
            (max_batch, self.max_pages_per_seq), dtype=np.int32
        )
        self._slot_free = list(range(max_batch))
        self._slot_req: Dict[int, _Request] = {}
        self._slot_pages: Dict[int, List[int]] = {}
        self._last_tok = np.zeros((max_batch,), dtype=np.int32)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._waiting: List[_Request] = []  # admitted-but-no-pages
        self._lock = threading.Lock()
        self._stop = False
        self._step_count = 0
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

        def decode_step(active):
            return self._decode_step(active)

        def prefill(req, slot, bucket, pages):
            return self._prefill_step(req, slot, bucket, pages)

        # Compile telemetry, as the JAX engine's: the decode step's key is
        # the batch shape (one compile), prefill's its bucket (one per
        # bucket). The decode tap rides a ring flushed once every 64 steps
        # and at every burst boundary (_loop, stats, shutdown), not per
        # token: the decode step is host-bound.
        self._decode = instrumented_step(
            decode_step, tap_stride=64, signature=lambda active: active.shape)
        self._prefill = instrumented_step(
            prefill, signature=lambda req, slot, bucket, pages: bucket)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- public API --------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               eos_token: Optional[int] = None) -> _Request:
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) exceeds "
                f"engine max_len({self.max_len})"
            )
        req = _Request(prompt, max_new_tokens, eos_token)
        need = self._pages_needed(req, self._bucket(len(prompt)))
        if need > self.total_pages:
            # Unsatisfiable ever: waiting would block the admission queue.
            raise ValueError(
                f"request needs {need} pages but the pool has only "
                f"{self.total_pages} (page_size={self.page_size})"
            )
        req._t0 = time.perf_counter()
        self._queue.put(req)
        return req

    def generate(self, prompt: List[int], max_new_tokens: int = 32,
                 eos_token: Optional[int] = None,
                 timeout: float = 300.0) -> List[int]:
        return self.submit(prompt, max_new_tokens, eos_token).result(timeout)

    def stats(self) -> Dict[str, Any]:
        # A telemetry read: publish what the decode tap ring holds, so the
        # series never lag a long burst.
        self._decode.flush_taps()
        with self._lock:
            return {
                "active_slots": len(self._slot_req),
                "free_slots": len(self._slot_free),
                "decode_steps": self._step_count,
                "free_pages": len(self._free_pages),
                "total_pages": self.total_pages,
                "page_size": self.page_size,
            }

    def shutdown(self):
        self._stop = True
        self._thread.join(timeout=5)
        self._decode.flush_taps()

    # ---- page accounting ---------------------------------------------------

    def _new_cache(self) -> PagedKVCache:
        return PagedKVCache.create(
            self.cfg, self.max_batch, self.total_pages, self.page_size,
            self.max_pages_per_seq, device=self.device,
        )

    def _pages_needed(self, req: _Request, bucket: int) -> int:
        decode_span = math.ceil(
            (len(req.prompt) + req.max_new_tokens) / self.page_size
        )
        return max(bucket // self.page_size, decode_span)

    def _reset_cache(self, cause: Exception):
        """Recover from a failed step: the pool may be half written, so
        rebuild it, then fail in-flight requests with the root cause (they
        cannot be resumed without their KV). A caller that sees the error
        finds the engine already serving from a fresh pool."""
        with self._lock:
            victims = list(self._slot_req.items())
            self._slot_req.clear()
            self._slot_free = list(range(self.max_batch))
            self._free_pages = list(range(self.total_pages))
            self._slot_pages.clear()
            self._table[:] = 0
        self.cache = self._new_cache()
        for _slot, req in victims:
            if not req.done.is_set():
                req.error = RuntimeError(
                    f"engine cache reset after runtime failure: {cause!r}"
                )
                req.done.set()
                req._live.put(None)

    def _release_slot(self, slot: int):
        pages = self._slot_pages.pop(slot, [])
        self._free_pages.extend(pages)
        self._table[slot, :] = 0
        self._slot_free.append(slot)

    # ---- engine loop -------------------------------------------------------

    def _bucket(self, n: int) -> int:
        bucket = self.page_size
        while bucket < n:
            bucket *= 2
        return min(bucket, self.max_len)

    def _prefill_step(self, req: _Request, slot: int, bucket: int,
                      pages: List[int]) -> int:
        dev = self.device
        self.cache = self.cache._replace(
            page_table=torch.as_tensor(self._table, device=dev))
        padded = req.prompt + [0] * (bucket - len(req.prompt))
        logits, self.cache = paged_prefill(
            self.params, torch.tensor([padded], dtype=torch.int32, device=dev),
            len(req.prompt), self.cache, self.cfg, slot,
            torch.tensor(pages, dtype=torch.long, device=dev),
        )
        return int(sample_logits(logits, self._generator,
                                 temperature=self.temperature)[0])

    def _admit(self):
        while self._slot_free:
            if self._waiting:
                req = self._waiting.pop(0)
            else:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return
            bucket = self._bucket(len(req.prompt))
            need = self._pages_needed(req, bucket)
            if need > len(self._free_pages):
                # Paged admission control: wait for pages to recycle.
                self._waiting.insert(0, req)
                return
            slot = self._slot_free.pop()
            pages = [self._free_pages.pop() for _ in range(need)]
            self._slot_pages[slot] = pages
            self._table[slot, :] = 0
            self._table[slot, :need] = pages
            try:
                first = self._prefill(req, slot, bucket,
                                      pages[: bucket // self.page_size])
            except Exception as e:  # noqa: BLE001 — the loop must survive
                # The pool may be half written: rebuild it (freeing every
                # slot and page) before this request sees its error.
                self._reset_cache(e)
                req.error = e
                req.done.set()
                req._live.put(None)
                continue
            req.ttft_s = time.perf_counter() - req._t0
            req.output.append(first)
            req._live.put(first)
            with self._lock:
                self._slot_req[slot] = req
            self._last_tok[slot] = first
            self._finish_if_done(slot, req, first)

    def _finish_if_done(self, slot: int, req: _Request, tok: int):
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_token is not None and tok == req.eos_token)):
            with self._lock:
                self._slot_req.pop(slot, None)
                self._release_slot(slot)
            req.done.set()
            req._live.put(None)

    def _decode_step(self, active: np.ndarray) -> np.ndarray:
        dev = self.device
        logits, self.cache = paged_decode(
            self.params, torch.as_tensor(self._last_tok, device=dev),
            self.cache, self.cfg, active=torch.as_tensor(active, device=dev),
        )
        nxt = sample_logits(logits, self._generator,
                            temperature=self.temperature)
        return nxt.cpu().numpy()

    def _loop(self):
        # inference_mode is thread-local: entered here, in the thread that
        # runs every prefill and decode step.
        with torch.inference_mode():
            while not self._stop:
                self._admit()
                with self._lock:
                    active_slots = dict(self._slot_req)
                if not active_slots:
                    # A burst boundary: the decode loop went idle, so
                    # publish the taps the ring holds.
                    self._decode.flush_taps()
                    time.sleep(0.002)
                    continue
                active = np.zeros((self.max_batch,), dtype=bool)
                active[list(active_slots)] = True
                try:
                    nxt = self._decode(active)
                except Exception as e:  # noqa: BLE001 — keep serving
                    self._reset_cache(e)
                    continue
                self._step_count += 1
                for slot, req in active_slots.items():
                    tok = int(nxt[slot])
                    req.output.append(tok)
                    req._live.put(tok)
                    self._last_tok[slot] = tok
                    self._finish_if_done(slot, req, tok)


class LLMDeployment:
    """Serve deployment wrapping an engine: deploy it with
    ``serve.run(serve.deployment(LLMDeployment).options(
    ray_actor_options={"num_gpus": 1, "max_concurrency": N}).bind(cfg))``
    so concurrent requests join the running decode loop (continuous
    batching) in a GPU replica. ``stream`` yields tokens as generated —
    route it through the proxy's SSE path (``POST /<name>/stream``) for
    live token streaming. ``params`` is the port's parameter tree, or a
    tree of numpy arrays (the JAX package's weights as numpy, say), which
    ``models/convert.params_from_numpy`` moves onto ``device``. Without
    ``params`` the weights come from ``checkpoint_path`` (a
    ``train.checkpoint`` directory holding the parameter tree, restored
    onto ``device``), else they are drawn from ``seed``. ``device``
    defaults to the card."""

    def __init__(self, cfg: Optional[LlamaConfig] = None, params=None, *,
                 checkpoint_path=None, max_batch: int = 8, max_len: int = 512,
                 temperature: float = 0.0, seed: int = 0,
                 page_size: int = 16, total_pages: Optional[int] = None,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        cfg = cfg if cfg is not None else LlamaConfig.tiny()
        if params is not None and isinstance(params["embed"], np.ndarray):
            params = params_from_numpy(params, cfg, dev)
        if params is None and checkpoint_path:
            params = Checkpoint(checkpoint_path).as_pytree(device=dev)
        if params is None:
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        self.engine = LLMEngine(cfg, params, max_batch=max_batch,
                                max_len=max_len, temperature=temperature,
                                page_size=page_size, total_pages=total_pages,
                                device=dev, seed=seed)

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        tokens = self.engine.generate(
            list(request["prompt"]),
            int(request.get("max_new_tokens", 32)),
            request.get("eos_token"),
        )
        return {"tokens": tokens}

    def stream(self, request: Dict[str, Any]):
        """Generator endpoint: one token per yield, as decoded."""
        req = self.engine.submit(
            list(request["prompt"]),
            int(request.get("max_new_tokens", 32)),
            request.get("eos_token"),
        )
        for tok in req.tokens(timeout=300.0):
            yield {"token": tok}

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()
