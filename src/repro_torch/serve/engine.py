"""Batched decode engine with slot-based continuous batching and
ProMIPS-approximate greedy logits; port of `repro.serve.engine`.

The decode-time logit computation argmax_v <h, E_v> over the output
embedding is a MIPS problem (the paper's multi-class prediction use case):
``logits_mode="promips"`` answers it with the c-k-AMIP search over an index
on the embedding rows, ``logits_mode="exact"`` with the dense h @ E^T.

Continuous batching: ``batch_slots`` slots, refilled from the queue on every
step; the requests admitted in one step are prefilled together, one
`transformer.prefill` per distinct prompt length, and their cache rows are
written into the batch cache at their slots (the port knows its cache
layout: K/V carry the batch on axis 1, ``len`` on axis 0). The decode
search runs over the active slots only, behind a `HotQueryCache` keyed on
(degradation tier, float16 fingerprint of the hidden row).

The embedding index is any mutable `api.Searcher`; by default the
``promips-stream`` backend over ``embed[:vocab]``, so `update` / `delete`
track embedding refreshes and vocabulary retirements mid-traffic.

Everything runs on ``device`` (the card by default). ``use_kernels`` has
`RuntimeConfig.use_kernels`'s meaning for both the model's
`decode_attention` and the search: None runs the CUDA kernels on the card
and the plain versions on the CPU, False the plain versions on the card,
True on the CPU raises. The hidden rows' fingerprints and the chosen tokens
go to the host every step, as in the JAX engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .. import api
from ..core.index import resolve_device
from ..core.runtime import RuntimeConfig
from ..models import transformer as model_lib
from ..obs import metrics as _metrics
from ..robust.faultpoints import fault
from ..robust.watchdog import EwmaWatchdog
from ..tune.space import HAND_PICKED
from .qcache import HotQueryCache


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None
    slot: int = -1
    # lifecycle timestamps (time.perf_counter seconds; 0.0 = not yet reached)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    # absolute perf_counter deadline; None is the only no-deadline sentinel
    # (0.0 is a real, already-passed deadline: it expires at admission)
    deadline: Optional[float] = None
    expired: bool = False             # dropped/terminated past its deadline


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Serve-path degradation ladder.

    Under sustained overload the engine steps down through ``tiers``: each
    entry is a verification block budget for the decode search (None / 1.0
    = the configured runtime; an int is an absolute block count; a float in
    (0, 1) a fraction of the index's block count, resolved at engine init),
    trading recall for latency before the queue cap sheds requests. When
    the queue drains it steps back up one tier at a time.

    Overload = queue depth >= ``queue_high``, or a step slower than
    ``latency_factor`` x the EWMA of recent steps (`robust.EwmaWatchdog`),
    for ``patience`` consecutive steps. Recovery = queue depth <=
    ``queue_low`` for ``recovery`` consecutive steps. ``recall_floors`` is
    the declared minimum recall@k per tier (a contract, not a runtime
    check).
    """

    tiers: tuple = (1.0, 0.5, 0.25)
    recall_floors: tuple = (0.95, 0.85, 0.6)
    queue_high: int = 8
    queue_low: int = 2
    latency_factor: float = 2.5
    alpha: float = 0.2                 # EWMA smoothing for step latency
    patience: int = 3                  # overloaded steps before step-down
    recovery: int = 8                  # calm steps before step-up

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("DegradationPolicy.tiers must be non-empty")
        if len(self.recall_floors) != len(self.tiers):
            raise ValueError("recall_floors must declare one floor per tier")
        if self.queue_low >= self.queue_high:
            raise ValueError("queue_low must be < queue_high (hysteresis)")


class DecodeEngine:
    def __init__(self, params, cfg, *, batch_slots: Optional[int] = None,
                 max_len: int = 512,
                 logits_mode: str = "exact", promips_kwargs: Optional[dict] = None,
                 promips_budget: Optional[int] = None, eos_id: int = 0,
                 search_runtime: Optional[RuntimeConfig] = None,
                 index: Optional[api.Searcher] = None,
                 obs: bool = False, max_queue: Optional[int] = None,
                 degradation: Optional[DegradationPolicy] = None,
                 default_deadline_s: Optional[float] = None,
                 result_cache: Optional[int] = None,
                 max_refill: Optional[int] = None,
                 device="cuda", use_kernels: Optional[bool] = None):
        if index is not None:
            if logits_mode != "promips":
                raise ValueError(
                    "index= requires logits_mode='promips' (exact mode has "
                    "no logit index; the given searcher would be ignored)")
            if not index.capabilities.supports_mutation:
                raise ValueError(
                    f"engine index backend {index.name!r} must support "
                    "mutation (capabilities.supports_mutation=True)")
            if promips_kwargs:
                raise ValueError(
                    "promips_kwargs only tunes the default-built index; "
                    "configure the injected searcher at its own build()")
        model_lib.check_supported(cfg)
        self.device = resolve_device(device)
        if use_kernels is not None and not isinstance(use_kernels, bool):
            raise ValueError(f"use_kernels must be None or a bool, got "
                             f"{use_kernels!r}")
        if use_kernels and self.device.type != "cuda":
            raise ValueError(f"use_kernels=True needs the card, the engine "
                             f"runs on {self.device}")
        self.use_kernels = use_kernels
        # the hand-picked serve knobs (the tuning cache is not ported);
        # explicit arguments win
        picked = HAND_PICKED["serve"]
        if batch_slots is None:
            batch_slots = int(picked["decode_batch_slots"])
        if result_cache is None:
            result_cache = int(picked["result_cache_size"])
        if max_refill is None:
            max_refill = picked["max_refill_per_step"]
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.b, self.max_len = batch_slots, max_len
        if max_refill is not None and int(max_refill) < 1:
            raise ValueError(f"max_refill must be >= 1 or None (= all free "
                             f"slots), got {max_refill!r}")
        self.max_refill = None if max_refill is None else int(max_refill)
        self.logits_mode = logits_mode
        self.eos_id = eos_id
        # serve-path telemetry: the serve.* instruments of obs.metrics, one
        # `if self.obs` check when off; max_queue bounds the backlog
        self.obs = bool(obs)
        self.max_queue = max_queue
        self.cache = model_lib.init_cache(cfg, batch_slots, max_len,
                                          self.params["embed"].dtype,
                                          device=self.device)
        self.active = np.zeros(batch_slots, bool)
        self.requests: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.steps = 0
        self.pages = 0
        self.searched_rows = 0          # hidden rows sent to the index
        self.prefill_calls = 0
        self.policy = degradation
        self.default_deadline_s = default_deadline_s
        self.tier = 0
        self.stepdowns = 0
        self.stepups = 0
        self.shed = 0
        self.deadline_drops = 0
        self._watch = EwmaWatchdog(
            threshold=degradation.latency_factor if degradation else 2.5,
            alpha=degradation.alpha if degradation else 0.2)
        self._over_streak = 0
        self._calm_streak = 0
        self._tier_cache: dict = {}
        self.qcache = None
        if logits_mode == "promips":
            if index is not None:
                self.index = index
            else:
                emb = self.params["embed"][: cfg.vocab].float().cpu().numpy()
                kw = dict(m=8, c=0.9, p=0.9, norm_strata=4, seed=0)
                kw.update(promips_kwargs or {})
                guarantee = api.GuaranteeConfig(c=kw.pop("c"), p0=kw.pop("p"))
                # streaming index: row id == vocab id; update()/delete()
                # absorb refreshes, compaction runs off the decode path
                self.index = api.build(emb, backend="promips-stream",
                                       guarantee=guarantee, auto_compact=True,
                                       seed=kw.pop("seed"), device=self.device,
                                       **kw)
            self._retired = np.zeros(cfg.vocab, bool)
            # the decode batch goes through batched verification by default
            # (the JAX engine's choice for decode-shaped batches); a given
            # RuntimeConfig is taken as it is, with k stamped in
            if search_runtime is None:
                search_runtime = RuntimeConfig(
                    mode="two_phase", verification="batched",
                    norm_adaptive=True, cs_prune=True, budget=promips_budget,
                    use_kernels=use_kernels)
            self.search_runtime = dataclasses.replace(search_runtime, k=4)
            # entries keyed (tier, fingerprint): a result computed at one
            # budget tier is never replayed at another
            self.qcache = HotQueryCache(int(result_cache))
        self._tier_budgets = (self._resolve_tier_budgets()
                              if degradation is not None else (None,))

    # -- degradation ladder ---------------------------------------------------
    def _resolve_tier_budgets(self) -> tuple:
        """The policy's tiers as absolute block budgets: None / 1.0 = the
        configured runtime, int = absolute, float in (0, 1) = a fraction of
        the index's block count (resolved here, once)."""
        blocks = None
        inner = getattr(getattr(self, "index", None), "inner", None)
        if inner is not None and hasattr(inner, "meta"):
            blocks = int(inner.meta.n_blocks)
        out = []
        for t in self.policy.tiers:
            if t is None or (isinstance(t, float) and t >= 1.0):
                out.append(None)
            elif isinstance(t, float):
                out.append(max(1, round(blocks * t)) if blocks else None)
            else:
                out.append(max(1, int(t)))
        return tuple(out)

    def _tier_runtime(self) -> RuntimeConfig:
        """The decode-search runtime of the current tier (one per tier)."""
        b = self._tier_budgets[self.tier]
        if b is None:
            return self.search_runtime
        rt = self._tier_cache.get(self.tier)
        if rt is None:
            rt = dataclasses.replace(self.search_runtime, budget=b, budget2=b)
            self._tier_cache[self.tier] = rt
        return rt

    def _ladder_tick(self, step_seconds: Optional[float]) -> None:
        """One hysteresis update: overload (deep queue or a straggler step)
        for ``patience`` steps steps down; calm (shallow queue) for
        ``recovery`` steps steps up. None = an idle tick (no latency)."""
        p = self.policy
        if p is None:
            return
        slow = (self._watch.observe(step_seconds)
                if step_seconds is not None else False)
        depth = len(self.queue)
        if depth >= p.queue_high or slow:
            self._over_streak += 1
            self._calm_streak = 0
        elif depth <= p.queue_low:
            self._calm_streak += 1
            self._over_streak = 0
        else:                       # hysteresis band: hold the current tier
            self._over_streak = 0
        if (self._over_streak >= p.patience
                and self.tier < len(self._tier_budgets) - 1):
            self.tier += 1
            self.stepdowns += 1
            self._over_streak = 0
            if self.obs:
                _metrics.counter("serve.tier_stepdowns").inc()
        elif self._calm_streak >= p.recovery and self.tier > 0:
            self.tier -= 1
            self.stepups += 1
            self._calm_streak = 0
            if self.obs:
                _metrics.counter("serve.tier_stepups").inc()
        if self.obs:
            _metrics.gauge("serve.degradation_tier").set(self.tier)
            _metrics.gauge("serve.step_latency_ewma").set(self._watch.ewma)

    # -- embedding mutation ---------------------------------------------------
    def update(self, ids, rows) -> None:
        """Refresh output-embedding rows mid-traffic. The engine's embed
        table gets the new rows (a copy: the caller's tensor is untouched);
        in promips mode they move to the index's delta segment and are
        scored exactly from the next step."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        if (ids < 0).any() or (ids >= self.cfg.vocab).any():
            raise ValueError("update ids must be valid vocab ids")
        d_emb = self.params["embed"].shape[-1]
        if rows.shape != (len(ids), d_emb):
            raise ValueError(f"rows must be ({len(ids)}, {d_emb}), "
                             f"got {rows.shape}")
        if self.logits_mode == "promips":
            # index first: it checks aliveness, so a rejected refresh leaves
            # the embed table untouched
            self.index.update(ids, rows)
            self.qcache.clear()   # cached results may predate the rows
        embed = self.params["embed"].clone()
        embed[torch.from_numpy(ids).to(embed.device)] = torch.from_numpy(
            rows).to(device=embed.device, dtype=embed.dtype)
        self.params = dict(self.params, embed=embed)

    def delete(self, ids) -> None:
        """Retire vocab ids from decoding: tombstoned in the embedding
        index, so the approximate greedy search never emits them again
        (promips mode only)."""
        if self.logits_mode != "promips":
            raise ValueError("delete() requires logits_mode='promips'")
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        self.index.delete(ids)
        self._retired[ids] = True  # admission prefill masks these too
        # a cached row may still name a retired id
        self.qcache.clear()
        if self.obs:
            _metrics.counter("serve.tombstones").inc(len(ids))

    def join_compaction(self, timeout: Optional[float] = None) -> None:
        if self.logits_mode == "promips":
            self.index.flush(timeout)

    # -- request lifecycle ----------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               deadline_s: Optional[float] = None) -> Optional[Request]:
        """Enqueue a request. Returns None (the request is shed) when
        ``max_queue`` is set and the backlog is at the cap. Malformed
        prompts raise ValueError. ``deadline_s`` (seconds from now; default
        ``default_deadline_s``) bounds the request's life: expired requests
        are dropped at admission, an active one past its deadline ends at
        the next step with its tokens so far."""
        prompt = self._validate_prompt(prompt)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.shed += 1
            if self.obs:
                _metrics.counter("serve.requests_shed").inc()
            return None
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      out_tokens=[], t_submit=now,
                      deadline=(now + deadline_s if deadline_s is not None
                                else None))
        self.queue.append(req)
        if self.obs:
            _metrics.counter("serve.requests_submitted").inc()
        return req

    def _validate_prompt(self, prompt) -> np.ndarray:
        arr = np.asarray(prompt)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array, "
                             f"got shape {arr.shape}")
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"prompt tokens must be integers, got dtype "
                             f"{arr.dtype}")
        if int(arr.min()) < 0 or int(arr.max()) >= self.cfg.vocab:
            raise ValueError(
                f"prompt token ids must be in [0, {self.cfg.vocab}), got "
                f"range [{int(arr.min())}, {int(arr.max())}]")
        return arr.astype(np.int32)

    def _expire(self, req: Request) -> None:
        req.expired = True
        req.t_done = time.perf_counter()
        self.deadline_drops += 1
        if self.obs:
            _metrics.counter("serve.deadline_expired").inc()

    def _admit(self):
        """Refill free slots from the queue: pop up to ``max_refill`` live
        requests (expired ones are dropped here), then prefill them together,
        one `prefill` per distinct prompt length."""
        admitted: List[Request] = []
        free = [s for s in range(self.b) if not self.active[s]]
        limit = len(free) if self.max_refill is None else \
            min(len(free), self.max_refill)
        for slot in free[:limit]:
            req = None
            while self.queue:
                cand = self.queue.pop(0)
                if (cand.deadline is not None
                        and time.perf_counter() > cand.deadline):
                    self._expire(cand)   # dead on arrival
                    continue
                req = cand
                break
            if req is None:
                break
            req.slot = slot
            admitted.append(req)
        by_len: dict = {}
        for req in admitted:
            by_len.setdefault(len(req.prompt), []).append(req)
        for group in by_len.values():
            self._prefill_group(group)

    def _prefill_group(self, group: List[Request]) -> None:
        """One batched prefill over same-length prompts; each row goes into
        its request's slot of the batch cache."""
        tokens = torch.from_numpy(np.stack([r.prompt for r in group])).to(
            self.device)
        cache_g, logits = model_lib.prefill(self.params, self.cfg,
                                            {"tokens": tokens}, self.max_len)
        self.prefill_calls += 1
        slots = torch.tensor([r.slot for r in group], device=self.device)
        self.cache["k"][:, slots] = cache_g["k"].to(self.cache["k"].dtype)
        self.cache["v"][:, slots] = cache_g["v"].to(self.cache["v"].dtype)
        self.cache["len"][slots] = cache_g["len"]
        lg = logits.float().cpu().numpy()
        lg[:, self.cfg.vocab:] = -np.inf   # the argmax lands on a vocab id
        if self.logits_mode == "promips":
            # retired ids are tombstoned in the index; keep the dense prefill
            # argmax consistent with the decode path
            lg[:, : self.cfg.vocab][:, self._retired] = -np.inf
        now = time.perf_counter()
        for i, req in enumerate(group):
            req.out_tokens.append(int(np.argmax(lg[i])))
            req.t_admit = now
            if self.obs:
                _metrics.histogram("serve.queue_wait_us").observe(
                    (req.t_admit - req.t_submit) * 1e6)
            self.active[req.slot] = True
            self.requests[req.slot] = req

    # -- main loop ------------------------------------------------------------
    def _promips_next_tokens(self, hidden) -> np.ndarray:
        """The decode search over the active slots only, with the hot-query
        cache in front of the index. Inactive slots carry stale hidden rows
        and are compacted out before the index is queried, so pages count
        only rows that decode a real token. Hits skip the search; misses
        are searched as one sub-batch and cached under (tier, fingerprint).
        A slot whose search returned id -1 (a starved finite budget) gets
        the eos id."""
        rt = self._tier_runtime()
        active_idx = np.flatnonzero(self.active)
        nxt = np.full(self.b, self.eos_id, np.int64)
        cache_on = self.qcache.capacity > 0
        miss_rows: List[int] = []
        if cache_on:
            h_np = hidden.float().cpu().numpy()
            keys = {}
            for s in active_idx:
                key = (self.tier, self.qcache.fingerprint(h_np[s]))
                keys[s] = key
                hit = self.qcache.get(key)
                if hit is None:
                    miss_rows.append(int(s))
                else:
                    nxt[s] = hit[0][0]
            if self.obs:
                _metrics.counter("serve.cache_hits").inc(
                    len(active_idx) - len(miss_rows))
                _metrics.counter("serve.cache_misses").inc(len(miss_rows))
        else:
            miss_rows = [int(s) for s in active_idx]
        if miss_rows:
            # all-active full-width batches skip the gather
            if len(miss_rows) == self.b:
                queries = hidden
            else:
                queries = hidden[torch.tensor(miss_rows, device=hidden.device)]
            res = self.index.search(queries, k=rt.k, runtime=rt)
            self.pages += res.stats["pages"]
            self.searched_rows += len(miss_rows)
            if self.obs:
                _metrics.counter("serve.pages").inc(res.stats["pages"])
            ev0 = self.qcache.evictions
            for i, s in enumerate(miss_rows):
                nxt[s] = res.ids[i, 0]
                if cache_on:
                    self.qcache.put(keys[s], res.ids[i], res.scores[i])
            if self.obs and self.qcache.evictions > ev0:
                _metrics.counter("serve.cache_evictions").inc(
                    self.qcache.evictions - ev0)
        return np.where(nxt >= 0, nxt, self.eos_id)

    def step(self) -> bool:
        """One engine step: admit, then decode one token for every active
        slot. Feeds the degradation ladder (when a policy is set)."""
        t0 = time.perf_counter()
        fault.at("serve.decode")
        self._admit()
        if not self.active.any():
            if self.obs:
                _metrics.gauge("serve.slot_occupancy").set(0.0)
                _metrics.gauge("serve.queue_depth").set(len(self.queue))
            self._ladder_tick(None)   # idle: queue signal only
            return False
        tokens = np.zeros((self.b, 1), np.int32)
        for slot in range(self.b):
            if self.active[slot]:
                tokens[slot, 0] = self.requests[slot].out_tokens[-1]
        tok = torch.from_numpy(tokens).to(self.device)
        if self.logits_mode == "promips":
            hidden, self.cache = model_lib.decode_step(
                self.params, self.cfg, self.cache, tok, return_hidden=True,
                use_kernels=self.use_kernels)
            nxt = self._promips_next_tokens(hidden)
        else:
            logits, self.cache = model_lib.decode_step(
                self.params, self.cfg, self.cache, tok,
                use_kernels=self.use_kernels)
            lg = logits.float().cpu().numpy()
            lg[..., self.cfg.vocab:] = -np.inf  # mask the vocab_padded tail
            nxt = np.argmax(lg, axis=-1)
            self.pages += self.cfg.vocab_padded * self.cfg.d_model * 4 // 4096 \
                * int(self.active.sum()) // max(self.b, 1)
        self.steps += 1
        now = time.perf_counter()
        for slot in range(self.b):
            if not self.active[slot]:
                continue
            req = self.requests[slot]
            req.out_tokens.append(int(nxt[slot]))
            # max_new_tokens counts decoded tokens, after the prefill argmax
            done = (len(req.out_tokens) - 1 >= req.max_new_tokens
                    or int(nxt[slot]) == self.eos_id)
            past_deadline = req.deadline is not None and now > req.deadline
            if done or past_deadline:
                self.active[slot] = False
                self.requests[slot] = None
                if past_deadline and not done:
                    self._expire(req)   # partial tokens retained
                else:
                    req.t_done = now
                    if self.obs:
                        _metrics.counter("serve.requests_completed").inc()
                        _metrics.histogram("serve.request_us").observe(
                            (req.t_done - req.t_submit) * 1e6)
        dt = time.perf_counter() - t0
        if self.obs:
            _metrics.counter("serve.decode_steps").inc()
            _metrics.histogram("serve.step_us").observe(dt * 1e6)
            _metrics.gauge("serve.slot_occupancy").set(
                float(self.active.sum()) / max(self.b, 1))
            _metrics.gauge("serve.queue_depth").set(len(self.queue))
        self._ladder_tick(dt)
        return True

    def run(self, max_steps: int = 10_000):
        while (self.queue or self.active.any()) and self.steps < max_steps:
            self.step()

    # -- telemetry ------------------------------------------------------------
    def _maintenance(self) -> Optional[dict]:
        idx = getattr(self, "index", None)
        if idx is None or not hasattr(idx, "maintenance_status"):
            return None
        return idx.maintenance_status()

    def health(self) -> dict:
        """State "ok" | "degraded" (ladder below tier 0) | "shedding"
        (backlog at the cap), the tier and its declared recall floor,
        queue and slot occupancy, the step-latency EWMA, deadline and shed
        totals, and the index's compaction and WAL status."""
        shedding = (self.max_queue is not None
                    and len(self.queue) >= self.max_queue)
        maint = self._maintenance()
        return {
            "state": ("shedding" if shedding
                      else "degraded" if self.tier > 0 else "ok"),
            "tier": self.tier,
            "tier_budget": (self._tier_budgets[self.tier]
                            if self.policy is not None else None),
            "tier_recall_floor": (self.policy.recall_floors[self.tier]
                                  if self.policy is not None else None),
            "queue_depth": len(self.queue),
            "active_slots": int(self.active.sum()),
            "step_latency_ewma_s": self._watch.ewma,
            "stepdowns": self.stepdowns,
            "stepups": self.stepups,
            "shed": self.shed,
            "deadline_drops": self.deadline_drops,
            "compaction": maint["compaction"] if maint else None,
            "wal_lag": maint["wal_lag"] if maint else 0,
        }

    def metrics_snapshot(self) -> dict:
        """Engine state plus every live ``serve.*`` instrument."""
        snap = {"steps": self.steps, "pages": self.pages,
                "searched_rows": self.searched_rows,
                "prefill_calls": self.prefill_calls,
                "queue_depth": len(self.queue),
                "active_slots": int(self.active.sum()),
                "tier": self.tier,
                "result_cache": (self.qcache.stats()
                                 if self.qcache is not None else None),
                "maintenance": self._maintenance()}
        snap.update({name: val for name, val in _metrics.snapshot().items()
                     if name.startswith("serve.")})
        return snap


def _to_device(tree, device):
    """A parameter tree's tensors on ``device`` (no copy where they are)."""
    if isinstance(tree, dict):
        return {key: _to_device(val, device) for key, val in tree.items()}
    return torch.as_tensor(tree).to(device)


__all__ = ["DecodeEngine", "DegradationPolicy", "Request"]
