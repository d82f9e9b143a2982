"""Serving loops: fixed-batch (static) and continuous-batching decode over a
request queue, with the KV cache living on the device across steps — the JAX
package's ``serving/engine.py`` on PyTorch.

``serve_static`` groups requests into fixed-size batches; each group prefills
together and decodes until every slot has hit its own EOS or budget.  A model
whose prefill reads more than tokens (``model.extra_inputs``: an
encoder-decoder's ``frames``, a VLM's ``patches``) is served through
``DecodeEngine.generate_batch(..., extra_inputs=...)``.

``ContinuousEngine`` is an admission queue with mid-stream slot refill: every
batch slot carries its own request state (budget, EOS id, RNG stream, absolute
position clock).  When a slot finishes, the host prefills the next queued
request (one fixed-shape prefill whose rows serve every slot freed that round)
and scatters the freed slots' rows of the fresh cache into the live cache.

PyTorch runs eagerly: the JAX engines jit ``prefill`` and the decode step
(the continuous engine's decode tick), and ``compile_counts()`` here counts,
for the same two entry points, the distinct signatures (tensor shapes and
dtypes, in their dict/list structure) each was called with — what the
reference's jit caches hold for the same calls.  A steady serve keeps
``{"prefill": 1, "decode_step": 1}``: a new shape after a refill would also
break a CUDA graph of the decode step.  ``compile_time_s`` is the one-time
CUDA kernel build (nvcc) that fell inside a traced phase, so the CLI can
still report steady-state throughput.  Every engine call runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.obs.trace import MAIN_TID, SLOT_TID0


@dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    eos_id: int = -1  # -1: never stops early


@dataclass
class Result:
    tokens: np.ndarray  # truncated at this request's first EOS (inclusive)
    prompt_len: int
    steps: int  # tokens generated for THIS request (== len(tokens))


def _trim_at_eos(tokens: np.ndarray, budget: int, eos_id: int) -> np.ndarray:
    """This request's tokens: at most ``budget``, cut at the first EOS
    (keeping the EOS token itself)."""
    tokens = tokens[:budget]
    if eos_id >= 0:
        hits = np.flatnonzero(tokens == eos_id)
        if hits.size:
            tokens = tokens[: hits[0] + 1]
    return tokens


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def _signature(tree):
    """The shapes and dtypes of the tensors in ``tree`` (dicts, lists and
    tuples walked in order, keys kept), as jit's cache key holds the abstract
    values of its arguments: Python numbers, None and meta tensors leave no
    trace."""
    if isinstance(tree, torch.Tensor):
        return None if tree.is_meta else (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(v) for v in tree)
    return None


class _EngineBase:
    """Shared engine plumbing: the build counts of the two entry points and
    the batch-round / wasted-slot-step counters both schedulers report.  A
    slot-round is one slot position in one sampling round (prefill round or
    decode step); it counts as wasted when it yields no token for a live
    request."""

    ENTRY_POINTS = ("prefill", "decode_step")

    def _init_builds(self) -> None:
        self._signatures = {name: set() for name in self.ENTRY_POINTS}
        self._params_sig = None  # the engine's params, walked once

    def _called(self, entry: str, *args) -> None:
        """Record the signature of one call of ``entry`` on ``self.params``
        and ``args``."""
        if self._params_sig is None:
            self._params_sig = _signature(self.params)
        self._signatures[entry].add((self._params_sig, _signature(args)))

    def compile_counts(self) -> dict:
        """Distinct call signatures of each entry point so far (the
        reference's jit cache sizes); ``reset_counters`` keeps them."""
        return {name: len(sigs) for name, sigs in self._signatures.items()}

    def reset_counters(self) -> None:
        self.batch_steps = 0  # sampling rounds (prefill rounds + decode steps)
        self.wasted_slot_steps = 0
        self.compile_time_s = 0.0  # wall time of phases that built a kernel
        self.metrics.reset()

    @property
    def wasted_fraction(self) -> float:
        total = self.B * self.batch_steps
        return self.wasted_slot_steps / total if total else 0.0


@contextmanager
def _phase_span(engine, tracer, name: str, cat: str = "serve", **args):
    """B/E span around one engine phase, recorded only when the caller already
    checked ``obs.enabled()``.  The body may set ``sync`` (a tensor whose
    device is synchronized before the E event, so durations measure work
    rather than enqueue) and ``end_args`` on the yielded dict.  If a CUDA
    kernel was built during the span, the span is flagged ``compiled=True``,
    a ``kernel.build`` instant is emitted, and the duration feeds
    ``engine.compile_time_s``.  After the span, ``st["dur_s"]`` holds the
    measured duration."""
    built_before = _build.build_seconds()
    tracer.begin(name, cat, **args)
    t0 = time.perf_counter()
    st: dict = {}
    try:
        yield st
        sync = st.get("sync")
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
    finally:
        st["dur_s"] = time.perf_counter() - t0
        end_args = dict(st.get("end_args") or {})
        if _build.build_seconds() > built_before:
            end_args["compiled"] = True
            engine.compile_time_s += st["dur_s"]
            tracer.instant("kernel.build", "build", phase=name)
        tracer.end(name, cat, **end_args)


def _place_engine_packs(model, mesh) -> None:
    """Place the model's sharded approx pack over ``mesh`` (default: the
    active ``use_sharding`` mesh) when an engine is built
    (``ApproxConfig.place_packs``): idempotent when ``build_model(cfg,
    mesh=...)`` placed it already.  Closures built after this call under
    ``use_sharding(mesh)`` hold one slice; the engine's own model keeps the
    closures it was built with (an unplaced pack still evaluates on a bound
    mesh whose 'model' axis is ``pack_shards`` wide)."""
    if mesh is None:
        from repro_torch.parallel.sharding import current_mesh

        mesh = current_mesh()
    approx = getattr(getattr(model, "cfg", None), "approx", None)
    if approx is not None:
        approx.place_packs(mesh)


def _check_engine_batch(engine, batch_size: int) -> None:
    if engine.B != batch_size:
        raise ValueError(f"engine batch size {engine.B} != requested "
                         f"{batch_size} (a passed engine overrides cache_len/"
                         "temperature/seed; batch_size must agree)")


class DecodeEngine(_EngineBase):
    """Fixed-batch prefill + decode (the static scheduler's inner engine)."""

    def __init__(self, model, params, batch_size: int, cache_len: int,
                 temperature: float = 0.0, seed: int = 0, mesh=None):
        _place_engine_packs(model, mesh)
        self.model = model
        self.params = params
        self.B = batch_size
        self.cache_len = cache_len
        self.temperature = temperature
        self.gen = torch.Generator(device=model.device).manual_seed(seed)
        self.metrics = obs.Registry()  # ttft_s / itl_s histograms
        self._init_builds()
        self.reset_counters()

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    @torch.inference_mode()
    def generate_batch(self, prompts: np.ndarray, max_new, eos_id=-1,
                       extra_inputs: Optional[dict] = None):
        """prompts: (B, S) int32, right-aligned equal length (caller pads).

        ``max_new`` and ``eos_id`` are scalars or (B,) per-slot vectors (-1: that
        slot never stops early).  ``extra_inputs`` adds entries to the prefill
        batch (``{"frames": (B, enc_len, d)}`` for an encoder-decoder,
        ``{"patches": (B, n_vis, d_vis)}`` for a VLM), arrays or tensors moved
        onto the model's device, floating ones as f32.  Returns ``(tokens,
        steps)``: the (B, steps) sampled tokens and the batch-wide
        sampling-round count; the loop stops as soon as EVERY slot has hit its
        own EOS or budget.  Decode positions count the prompt's tokens only
        (``S + i``), as the reference's engine does, also for a VLM's prefix.
        """
        B, S = prompts.shape
        if B != self.B:
            raise ValueError(f"prompts batch {B} != engine batch {self.B}")
        dev = self.model.device
        rec = obs.enabled()
        tracer = obs.get_tracer() if rec else None
        t0 = time.perf_counter()
        eos = np.broadcast_to(np.asarray(eos_id, np.int64), (B,))
        budget = np.broadcast_to(np.asarray(max_new, np.int64), (B,))
        horizon = int(budget.max())
        cache = self.model.init_cache(B, self.cache_len)
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=dev)}
        for k, v in (extra_inputs or {}).items():
            t = torch.as_tensor(v, device=dev)
            batch[k] = t.to(torch.float32) if t.is_floating_point() else t
        cm = (_phase_span(self, tracer, "static.prefill", batch=B, prompt_len=S)
              if rec else nullcontext({}))
        with cm as st:
            self._called("prefill", batch, cache)
            logits, cache = self.model.prefill(self.params, batch, cache)
            st["sync"] = logits
        out = [self._sample(logits)]
        self.batch_steps += 1
        if rec:
            _host(out[0])  # settle the first tokens for an honest TTFT
            self.metrics.histogram("ttft_s").observe(time.perf_counter() - t0)
        has_eos = bool((eos >= 0).any())
        done = budget <= 1
        if has_eos:
            done = done | ((eos >= 0) & (_host(out[0]) == eos))
        steps = 1  # the prefill logits already yielded one token
        cm = (_phase_span(self, tracer, "static.decode") if rec else nullcontext({}))
        with cm as st:
            for i in range(horizon - 1):
                if done.all():
                    break
                self.wasted_slot_steps += int(done.sum())
                tok = out[-1][:, None]
                pos = torch.tensor(S + i, device=dev)
                self._called("decode_step", tok, pos, cache)
                logits, cache = self.model.decode_step(self.params, tok, pos, cache)
                nxt = self._sample(logits)
                out.append(nxt)
                steps += 1
                self.batch_steps += 1
                done = done | (budget <= steps)
                if has_eos:
                    done = done | ((eos >= 0) & (_host(nxt) == eos))
            st["sync"] = out[-1]
            st["end_args"] = {"steps": steps - 1}
        if rec and steps > 1:
            itl = st["dur_s"] / (steps - 1)
            hist = self.metrics.histogram("itl_s")
            for _ in range(steps - 1):
                hist.observe(itl)
        return np.stack([_host(t) for t in out], axis=1), steps


def pad_and_batch(requests: List[Request], batch_size: int, pad_id: int = 0):
    """Left-pad prompts to a common length; group into fixed-size batches."""
    groups = [requests[i : i + batch_size]
              for i in range(0, len(requests), batch_size)]
    out = []
    for g in groups:
        while len(g) < batch_size:
            g = g + [Request(prompt=np.zeros((1,), np.int32), max_new_tokens=1)]
        maxlen = max(len(r.prompt) for r in g)
        toks = np.full((batch_size, maxlen), pad_id, np.int32)
        for i, r in enumerate(g):
            toks[i, maxlen - len(r.prompt):] = r.prompt
        out.append((g, toks))
    return out


def serve_static(model, params, requests: List[Request], batch_size: int,
                 cache_len: int, temperature: float = 0.0, seed: int = 0,
                 engine: Optional[DecodeEngine] = None) -> List[Result]:
    """Fixed-group scheduler: one prefill + decode loop per group of
    ``batch_size`` requests (short groups padded with 1-token dummies).
    A passed ``engine``'s own cache_len/temperature/seed apply."""
    if engine is None:
        engine = DecodeEngine(model, params, batch_size, cache_len, temperature,
                              seed)
    else:
        _check_engine_batch(engine, batch_size)
    results: List[Result] = []
    for group, toks in pad_and_batch(requests, batch_size):
        budgets = np.asarray([r.max_new_tokens for r in group], np.int64)
        eos = np.asarray([r.eos_id for r in group], np.int64)
        gen, _ = engine.generate_batch(toks, budgets, eos)
        for i, r in enumerate(group):
            kept = _trim_at_eos(gen[i], r.max_new_tokens, r.eos_id)
            results.append(Result(tokens=kept, prompt_len=len(r.prompt),
                                  steps=len(kept)))
    return results[: len(requests)]


# Legacy name of the fixed-batch path, as in the reference.
serve = serve_static


# ======================================================================================
# Continuous batching: admission queue + mid-stream slot refill
# ======================================================================================


def cache_batch_axes(model, cache_len: int) -> Dict[str, int]:
    """Per-entry batch axis of the model's decode cache, inferred by comparing
    caches (shapes only, on the meta device) at two batch sizes.  Every entry
    must carry exactly one batch axis, or slot refill cannot move its rows."""
    a = model.init_cache(1, cache_len, device="meta")
    b = model.init_cache(2, cache_len, device="meta")
    axes = {}
    for name in a:
        diffs = [i for i, (p, q) in enumerate(zip(a[name].shape, b[name].shape))
                 if p != q]
        if len(diffs) != 1:
            raise ValueError(
                f"cache entry {name!r} without a unique batch axis: "
                f"{tuple(a[name].shape)} vs {tuple(b[name].shape)} — "
                "ContinuousEngine needs per-slot cache rows")
        axes[name] = diffs[0]
    return axes


def scatter_cache_slots(dst, src, slot_ids: Sequence[int], axes: Dict[str, int]):
    """New cache with dst[..., slot, ...] = src[..., slot, ...] for each
    refilled slot, per entry along its batch axis (dst is left unchanged)."""
    any_t = next(iter(dst.values()))
    sl = torch.as_tensor(list(slot_ids), dtype=torch.int64, device=any_t.device)
    return {k: dst[k].index_copy(axes[k], sl, src[k].index_select(axes[k], sl))
            for k in dst}


@dataclass
class _Slot:
    req_idx: int
    prompt_len: int
    budget: int
    eos_id: int
    emitted: list = field(default_factory=list)


class ContinuousEngine(_EngineBase):
    """Admission queue + per-slot lifecycle + mid-stream slot refill.

    Every prompt is left-padded to one fixed prefill width (``prefill_len``,
    default: the queue's longest prompt); per-slot position clocks keep every
    decode tick at one shape.  For a dense stack, greedy output is
    token-identical to serving each request alone (the per-request oracle):
    slot rows never interact, and a refilled slot's scattered cache rows are
    exactly the rows a solo prefill would have produced.  An MoE stack's rows
    do interact: expert capacity is shared across the batch, so a slot's
    neighbours (drained slots decoding garbage included) change its routing
    and drops; its oracle is the same queue through the ``_ref`` mode, and the
    reference's cross-family engine test leaves MoE out for this reason.
    Token-only prompts: a model whose prefill needs extra inputs (encoder
    frames, vision patches; ``model.extra_inputs``) is refused, and served
    by ``serve_static`` / ``DecodeEngine.generate_batch`` only.
    """

    def __init__(self, model, params, batch_size: int, cache_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 prefill_len: Optional[int] = None, pad_id: int = 0, mesh=None):
        if model.extra_inputs:
            raise ValueError(
                f"ContinuousEngine serves token-only prompts; {model.cfg.name}'s "
                f"prefill also needs {list(model.extra_inputs)}: use "
                "DecodeEngine.generate_batch(..., extra_inputs=...)")
        _place_engine_packs(model, mesh)
        self.model = model
        self.params = params
        self.B = batch_size
        self.cache_len = cache_len
        self.temperature = temperature
        self.seed = seed
        self.prefill_len = prefill_len
        self.pad_id = pad_id
        self.metrics = obs.Registry()  # ttft_s / itl_s / queue_wait_s
        self._axes = None
        self._fresh = None
        self._init_builds()
        self.reset_counters()

    def reset_counters(self) -> None:
        super().reset_counters()
        self.prefills = 0
        self.refills = 0  # admissions into a previously-used slot

    def _tick(self, tok, pos, cache):
        """One decode tick (the ``decode_step`` entry point): step + greedy
        argmax + clock advance, with the fed-back token and the per-slot
        positions staying on the device."""
        self._called("decode_step", tok, pos, cache)
        logits, cache = self.model.decode_step(self.params, tok, pos, cache)
        nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None], logits, pos + 1, cache

    # ------------------------------ sampling ---------------------------------

    def _sample_row(self, row: np.ndarray, req_idx: int, tok_step: int) -> int:
        """Per-request RNG stream: token ``tok_step`` of request ``req_idx``
        depends only on (engine seed, req_idx, tok_step, that row's logits) —
        reproducible regardless of which slot the request landed in.  (Gumbel-
        max over numpy's generator: the JAX engine's bits are not reproduced.)"""
        if self.temperature <= 0.0:
            return int(np.argmax(row))
        rng = np.random.default_rng([self.seed, req_idx, tok_step])
        g = rng.gumbel(size=row.shape)
        return int(np.argmax(row.astype(np.float64) / self.temperature + g))

    # ------------------------------- serve -----------------------------------

    @torch.inference_mode()
    def serve(self, requests: List[Request],
              on_result: Optional[Callable[[int, Result], None]] = None
              ) -> List[Result]:
        if not requests:
            return []
        B = self.B
        dev = self.model.device
        S0 = self.prefill_len or max(len(r.prompt) for r in requests)
        longest = max(len(r.prompt) for r in requests)
        if longest > S0:
            raise ValueError(f"prompt of length {longest} exceeds the "
                             f"prefill width {S0}")
        if S0 > self.cache_len:
            raise ValueError(f"prefill width {S0} exceeds cache_len "
                             f"{self.cache_len}")
        if self._axes is None:
            self._axes = cache_batch_axes(self.model, self.cache_len)
        if self._fresh is None:
            self._fresh = self.model.init_cache(B, self.cache_len)

        rec = obs.enabled()
        tracer = obs.get_tracer() if rec else None
        t0 = time.perf_counter()
        if rec:
            tracer.set_thread_name(MAIN_TID, "engine")
            tracer.instant("serve.begin", "serve", requests=len(requests),
                           batch=B, prefill_len=S0)

        results: List[Optional[Result]] = [None] * len(requests)
        pending = deque(enumerate(requests))
        live: List[Optional[_Slot]] = [None] * B
        used = [False] * B  # slots occupied before (this call): refill marker
        cache = self._fresh
        pos = np.zeros((B,), np.int64)  # host mirror of the per-slot clocks
        last = np.zeros((B,), np.int64)  # host mirror of last sampled tokens
        tok_dev = None  # (B, 1) device-resident fed-back token
        pos_dev = None  # (B,) device-resident clocks

        def emit(j: int, tok: int) -> None:
            s = live[j]
            s.emitted.append(tok)
            if (s.eos_id >= 0 and tok == s.eos_id) or \
                    len(s.emitted) >= s.budget:
                res = Result(tokens=np.asarray(s.emitted, np.int64),
                             prompt_len=s.prompt_len, steps=len(s.emitted))
                results[s.req_idx] = res
                if on_result is not None:
                    on_result(s.req_idx, res)
                if rec:
                    tracer.end("request", "request", SLOT_TID0 + j,
                               tokens=len(s.emitted))
                live[j] = None

        while True:
            # admission: one fixed-shape prefill serves every free slot
            # (budget-1 / instant-EOS admissions free their slot immediately,
            # so keep refilling until slots or queue run dry)
            admitted = False
            while pending and any(s is None for s in live):
                free = [j for j in range(B) if live[j] is None]
                rows = np.full((B, S0), self.pad_id, np.int32)
                take = []
                for j in free:
                    i, r = None, None
                    while pending:  # zero-budget requests never take a slot
                        i, r = pending.popleft()
                        if r.max_new_tokens >= 1:
                            break
                        res = Result(tokens=np.zeros((0,), np.int64),
                                     prompt_len=len(r.prompt), steps=0)
                        results[i] = res
                        if on_result is not None:
                            on_result(i, res)
                        i, r = None, None
                    if r is None:
                        break
                    rows[j, S0 - len(r.prompt):] = r.prompt
                    take.append((j, i, r))
                if not take:
                    break
                t_admit = time.perf_counter()
                cm = (_phase_span(self, tracer, "refill.prefill",
                                  admitted=len(take)) if rec else nullcontext({}))
                with cm as st:
                    tokens = torch.as_tensor(rows, dtype=torch.int64, device=dev)
                    self._called("prefill", {"tokens": tokens}, self._fresh)
                    logits, rcache = self.model.prefill(
                        self.params, {"tokens": tokens}, self._fresh)
                    st["sync"] = logits
                self.prefills += 1
                self.batch_steps += 1
                self.wasted_slot_steps += B - len(take)
                self.refills += sum(used[j] for j, _, _ in take)
                for j, _, _ in take:
                    used[j] = True
                cm = (_phase_span(self, tracer, "refill.scatter",
                                  slots=len(take)) if rec else nullcontext({}))
                with cm as st:
                    cache = scatter_cache_slots(cache, rcache,
                                                [j for j, _, _ in take],
                                                self._axes)
                    st["sync"] = next(iter(cache.values()))
                lg = _host(logits.float())
                for j, i, r in take:
                    live[j] = _Slot(req_idx=i, prompt_len=len(r.prompt),
                                    budget=r.max_new_tokens, eos_id=r.eos_id)
                    pos[j] = S0
                    if rec:
                        tracer.set_thread_name(SLOT_TID0 + j, f"slot {j}")
                        tracer.begin("request", "request", SLOT_TID0 + j,
                                     req_idx=i, prompt_len=len(r.prompt),
                                     budget=r.max_new_tokens)
                        self.metrics.histogram("queue_wait_s").observe(
                            t_admit - t0)
                    tok = self._sample_row(lg[j], i, 0)
                    last[j] = tok
                    if rec:
                        tracer.instant("first_token", "request",
                                       SLOT_TID0 + j, req_idx=i)
                        self.metrics.histogram("ttft_s").observe(
                            time.perf_counter() - t0)
                    emit(j, tok)
                admitted = True
                if rec:
                    tracer.counter("slots_occupied",
                                   sum(s is not None for s in live))

            if all(s is None for s in live):
                break

            if admitted or tok_dev is None:
                # push the host mirrors once per refill round, not per tick
                tok_dev = torch.as_tensor(last[:, None], dtype=torch.int64,
                                          device=dev)
                pos_dev = torch.as_tensor(pos, dtype=torch.int32, device=dev)

            # Greedy slots with no live EOS can only leave the batch at a
            # known budget boundary: run that many ticks with no host
            # feedback, then settle the span with one sync.  EOS-bearing or
            # sampled slots need per-tick feedback (k = 1).
            alive = [s for s in live if s is not None]
            if self.temperature <= 0.0 and all(s.eos_id < 0 for s in alive):
                k = min(s.budget - len(s.emitted) for s in alive)
            else:
                k = 1
            n_free = sum(s is None for s in live)
            cm = (_phase_span(self, tracer, "decode.span", k=k, slots=B - n_free)
                  if rec else nullcontext({}))
            with cm as st:
                pend = []
                for _ in range(k):
                    tok_dev, logits, pos_dev, cache = self._tick(
                        tok_dev, pos_dev, cache)
                    pend.append(tok_dev)
                    self.batch_steps += 1
                    self.wasted_slot_steps += n_free
                if self.temperature <= 0.0:
                    span = [_host(t)[:, 0] for t in pend]
                else:  # k == 1: per-slot RNG sampling overrides argmax token
                    lg = _host(logits.float())
                    toks = last.copy()
                    for j in range(B):
                        if live[j] is not None:
                            toks[j] = self._sample_row(lg[j], live[j].req_idx,
                                                       len(live[j].emitted))
                    tok_dev = torch.as_tensor(toks[:, None], dtype=torch.int64,
                                              device=dev)
                    span = [toks]
            if rec and B > n_free:
                itl = st["dur_s"] / k
                hist = self.metrics.histogram("itl_s")
                for _ in range(k * (B - n_free)):
                    hist.observe(itl)
            for toks in span:
                for j in range(B):
                    s = live[j]
                    if s is None:
                        continue  # drained queue: slot decodes garbage
                    last[j] = toks[j]
                    emit(j, int(toks[j]))
            pos += k
            if rec:
                tracer.counter("slots_occupied",
                               sum(s is not None for s in live))

        return results


def serve_continuous(model, params, requests: List[Request], batch_size: int,
                     cache_len: int, temperature: float = 0.0, seed: int = 0,
                     prefill_len: Optional[int] = None,
                     engine: Optional[ContinuousEngine] = None) -> List[Result]:
    """Continuous-batching scheduler (admission queue + mid-stream refill).
    A passed ``engine``'s own cache_len/temperature/seed/prefill_len apply
    and those arguments are ignored; its batch size must agree."""
    if engine is None:
        engine = ContinuousEngine(model, params, batch_size, cache_len,
                                  temperature, seed, prefill_len=prefill_len)
    else:
        _check_engine_batch(engine, batch_size)
    return engine.serve(requests)
