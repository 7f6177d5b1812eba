"""Continuous-batching serving engine over the paged KV cache.

Port of flash_attention_cute_tpu/runtime/engine.py (`ServingEngine`, its
greedy and temperature paths) for the Llama family:

  * batch slots: a fixed number; a request holds one slot for life.
  * page pool:   `num_pages x page_size` per layer on the device of the
                 parameters, in the model's dtype or, with `kv_dtype=
                 torch.int8 | torch.float8_e4m3fn`, quantized per token
                 (kernels QA, B8, B9); page tables are assembled on the host by the
                 native scheduler (csrc/page_allocator.cpp via
                 runtime/native.py), which also admits FCFS within priority
                 classes and picks preemption victims.
  * admission:   whole-prompt prefill in groups of up to `prefill_group`
                 requests (kernel P), or with `prefill_chunk > 0` chunked
                 admission, one chunk per engine round for every admitting
                 slot in one extend forward (kernel B6).
  * decode:      `decode_chunk` decode forwards per round over all slots
                 (kernels B5 + D2); inactive slots are masked.
  * preemption:  recompute semantics: a victim restarts from its prompt.
                 Sampling is keyed by (request seed, output position), so a
                 replay draws the same samples.

Host waits: the engine keeps host mirrors of the page table and lengths and
uploads them once per forward; a decode round brings its [chunk, slots]
tokens back in one transfer, an admission wave its first tokens in one. The
prompt group is padded to its longest prompt (the JAX engine pads to a
power-of-two bucket and group size to bound TPU compiles; the tokens are the
same either way).

Usage:
    eng = ServingEngine(params, cfg, slots=4, num_pages=129, page_size=16,
                        pages_per_seq=16)
    eng.submit(0, prompt_ids_list, max_new_tokens=32)
    results = eng.run()   # {req_id: [token, ...]}
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from flash_attention_cute_tpu_torch.models.config import ModelConfig
from flash_attention_cute_tpu_torch.runtime.native import NativeScheduler
from flash_attention_cute_tpu_torch.ops.quantized import KV_DTYPES
from flash_attention_cute_tpu_torch.runtime.paged_cache import (
    PageAllocator,
    create_paged_state,
    create_quantized_paged_state,
)
from flash_attention_cute_tpu_torch.runtime.paged_forward import forward_paged
# `_uniform`: the engine's keyed uniforms (stream 0), which its tests read here.
from flash_attention_cute_tpu_torch.runtime.sampling import keyed_uniform as _uniform  # noqa: F401
from flash_attention_cute_tpu_torch.runtime.sampling import sample_keyed

# Options of the JAX engine that later slices bring: name -> (neutral value,
# where it stands in ROADMAP.md). Anything but the neutral value raises.
_LATER_INIT = {
    "mesh": (None, "tensor-parallel serving is ROADMAP.md A12"),
    "lora_params": (None, "multi-LoRA serving is ROADMAP.md A10c"),
    "dfa": (None, "guided decoding is ROADMAP.md A7c"),
    "enable_prefix_cache": (False, "the prefix cache is ROADMAP.md A7b"),
    "host_swap_tokens": (0, "the host swap tier is ROADMAP.md A7b"),
    "return_logprobs": (False, "logprobs are ROADMAP.md A7c"),
    "collect_clamp_stats": (False, "the port's softmax is exact and counts no clamps "
                            "(ROADMAP.md, TPU workarounds the port does not copy)"),
}
_LATER_SUBMIT = {
    "logit_bias": (None, "guided decoding is ROADMAP.md A7c"),
    "min_new_tokens": (0, "guided decoding is ROADMAP.md A7c"),
    "stop_sequences": (None, "guided decoding is ROADMAP.md A7c"),
    "constrain": (False, "guided decoding is ROADMAP.md A7c"),
    "adapter": (0, "multi-LoRA serving is ROADMAP.md A10c"),
    "repetition_penalty": (1.0, "sampling penalties are ROADMAP.md A7c"),
    "presence_penalty": (0.0, "sampling penalties are ROADMAP.md A7c"),
    "frequency_penalty": (0.0, "sampling penalties are ROADMAP.md A7c"),
}


def _refuse_later(where: str, options: dict, later: dict) -> None:
    for name, value in options.items():
        if name not in later:
            raise TypeError(f"{where}() got an unexpected keyword argument {name!r}")
        neutral, item = later[name]
        if value is not neutral and value != neutral:
            raise NotImplementedError(f"{where}({name}=...): {item}")


def _decode_chunk(params, cfg, last, state, chunk, sampling, seeds, positions):
    """Decode `chunk` tokens for every slot: a Python loop of decode forwards
    that queues work without waiting on the card. Returns (tokens [chunk,
    slots] on the device, state). Inactive slots (length 0) produce tokens
    the host discards; their lengths do not advance."""
    tok, out = last, []
    for i in range(chunk):
        logits, state = forward_paged(params, cfg, tok[:, None], state, mode="decode")
        tok = sample_keyed(logits[:, 0], sampling, seeds, positions + i)
        out.append(tok)
    return torch.stack(out), state


@dataclasses.dataclass
class _Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    # submit -> first token host-visible -> finished. A preemption replay
    # keeps the original first-token time (the user saw it once).
    submit_t: float = 0.0
    first_token_t: float | None = None
    finish_t: float | None = None


class ServingEngine:
    """Host-side serving loop over the paged device state."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        slots: int,
        num_pages: int,
        page_size: int,
        pages_per_seq: int,
        dtype=None,
        kv_dtype=None,  # torch.int8 / torch.float8_e4m3fn: quantized pages
        sampling=None,  # SamplingParams | None (None / temperature <= 0: greedy)
        seed: int = 0,
        prefill_group: int = 1,  # whole-prompt admissions per prefill forward
        prefill_chunk: int = 0,  # > 0: chunked admission, this many tokens a round
        eos_token_id: int | None = None,
        decode_chunk: int = 8,  # decode forwards per engine round
        **later,
    ):
        _refuse_later("ServingEngine", later, _LATER_INIT)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.sampling = sampling
        self.seed = seed
        self.prefill_group = max(1, prefill_group)
        self.prefill_chunk = max(0, prefill_chunk)
        self.decode_chunk = max(1, decode_chunk)
        self.eos_token_id = eos_token_id
        self.device = params["embed"].device
        # A 1-byte kv_dtype selects quantized pages; any other selects the
        # dense pool in `dtype`, as in the JAX engine.
        if kv_dtype is not None and kv_dtype.itemsize == 1:
            if kv_dtype not in KV_DTYPES:
                raise NotImplementedError(
                    f"kv_dtype={kv_dtype}: the port's quantized pages hold int8 or "
                    "float8_e4m3fn values (ROADMAP.md A8a)")
            self.state = create_quantized_paged_state(
                cfg, num_pages, page_size, batch=slots, pages_per_seq=pages_per_seq,
                dtype=kv_dtype, device=self.device)
        else:
            self.state = create_paged_state(cfg, num_pages, page_size, batch=slots,
                                            pages_per_seq=pages_per_seq, dtype=dtype,
                                            device=self.device)
        # Host mirrors of the device page table and lengths, uploaded once
        # per forward.
        self._table = np.zeros((slots, pages_per_seq), np.int32)
        self._lengths = np.zeros((slots,), np.int32)
        self.sched = NativeScheduler(num_pages, page_size, pages_per_seq, slots)
        self.native = True
        self._prefilling: dict[int, int] = {}  # slot -> prompt tokens written
        self._requests: dict[int, _Request] = {}
        self._slot_req: list[int] = [-1] * slots
        self._done: dict[int, list[int]] = {}
        self._failed: list[int] = []
        self.stats = {
            "steps": 0,
            "prefills": 0,
            "preemptions": 0,
            "tokens_generated": 0,
            "requests_finished": 0,
            "requests_failed": 0,
            # Forwards launched (prefill group, extend, decode chunk): the
            # events the JAX engine counts as device programs.
            "device_calls": 0,
            # The port's softmax is exact: nothing is ever clamped.
            "softmax_clamps": 0,
            # The prefix cache and host swap tier come in a later slice.
            "prefix_hit_tokens": 0,
            "prefix_evictions": 0,
            "swap_out_pages": 0,
            "swap_in_pages": 0,
        }
        # Forwards by mode and host seconds of decode rounds (launch-count
        # checks and per-round times of chip_smoke.py).
        self.forwards = {"prefill": 0, "extend": 0, "decode": 0}
        self.decode_rounds = 0
        self.decode_round_s = 0.0
        self.metrics: list[dict] = []

    # ---- public API ----

    def submit(self, req_id: int, prompt: list[int], max_new_tokens: int, *,
               priority: int = 0, **later):
        """Queue a request; `priority` higher admits sooner and is preempted
        later (FIFO within a priority class)."""
        _refuse_later("submit", later, _LATER_SUBMIT)
        if req_id < 0 or req_id in self._requests:
            raise ValueError(f"req_id {req_id} is negative or already queued")
        if not prompt:
            raise ValueError("a request needs at least one prompt token")
        self._requests[req_id] = _Request(req_id, list(prompt), max_new_tokens,
                                          submit_t=time.monotonic())
        self.sched.submit(req_id, len(prompt), max_new_tokens, priority)

    def run(self, max_steps: int = 100000) -> dict[int, list[int]]:
        """Drive until all submitted requests finish. Returns generations."""
        drained = False
        for _ in range(max_steps):
            if not self.step():
                drained = True
                break
        # Only when step() returned False with requests still queued are
        # those requests unservable at this pool size: surface them as
        # failed. When max_steps runs out they are merely unfinished.
        if drained:
            resident = set(self._slot_req)
            for rid in list(self._requests):
                if rid not in resident:
                    self._failed.append(rid)
                    self.stats["requests_failed"] += 1
                    del self._requests[rid]
        return dict(self._done)

    @property
    def failed(self) -> list[int]:
        return list(self._failed)

    @property
    def request_metrics(self) -> list[dict]:
        """Per-finished-request latency records: req_id, prompt_len,
        new_tokens, ttft_s (submit -> first token host-visible), e2e_s
        (submit -> finished)."""
        return list(self.metrics)

    # ---- engine loop ----

    def step(self, max_chunk: int | None = None) -> bool:
        """One admission + decode round. False when nothing is in flight.

        Decodes up to `max_chunk` (default `decode_chunk`) tokens per round;
        the chunk is capped so no active request finishes mid-chunk, and page
        room for the whole chunk is reserved up front (preempting on
        exhaustion)."""
        if max_chunk is None:
            max_chunk = self.decode_chunk
        self.stats["steps"] += 1
        self._admit()
        self._finish_ready()  # e.g. EOS as the very first prefill token
        self._advance_prefills()
        active = self._decoding_slots()
        if not active:
            if self._prefilling:
                return True
            return self.sched.num_waiting > 0 and self._drain_unservable()

        chunk = max(1, min([max_chunk] + [
            self._requests[self._slot_req[s]].max_new_tokens
            - len(self._requests[self._slot_req[s]].generated)
            for s in active
        ]))

        # Reserve `chunk` tokens of page room per active slot before the
        # decode; preempt on page exhaustion.
        for s in active:
            if self._slot_req[s] == -1:
                continue
            ok = True
            for _ in range(chunk):
                if self.sched.step_slot(s) == 1:
                    continue
                victim = self.sched.preempt_youngest()
                if victim != -1:
                    self.stats["preemptions"] += 1
                    self._evict(victim)
                    if victim != s and self.sched.step_slot(s) == 1:
                        continue
                    # s itself was the victim, or it is still starved: it
                    # must leave the batch this round (a resident slot
                    # decodes the whole chunk into reserved pages).
                    if victim != s:
                        self.stats["preemptions"] += 1
                        self.sched.release_slot(s, requeue=True)
                        self._evict(s)
                    ok = False
                    break
                # Unservable at this pool size: fail the request.
                self.sched.release_slot(s, requeue=False)
                self._evict(s, failed=True)
                ok = False
                break
            if ok:
                self._sync_table(s)

        active = self._decoding_slots()
        if not active:
            return (self.sched.num_waiting > 0) or bool(self._requests)

        last = np.zeros((self.slots,), np.int32)
        seeds = np.zeros((self.slots,), np.int64)
        positions = np.zeros((self.slots,), np.int64)
        for s in active:
            rid = self._slot_req[s]
            req = self._requests[rid]
            last[s] = (req.prompt + req.generated)[-1]
            seeds[s] = self._req_seed(rid)
            positions[s] = len(req.generated)
        t0 = time.perf_counter()
        state = dataclasses.replace(self.state, page_table=self._upload(self._table),
                                    lengths=self._upload(self._lengths))
        tokens, self.state = _decode_chunk(
            self.params, self.cfg, self._upload(last), state, chunk, self.sampling,
            self._upload(seeds), self._upload(positions),
        )
        self.stats["device_calls"] += 1
        tokens = tokens.cpu().numpy()  # [chunk, slots]: the round's one wait
        self.forwards["decode"] += chunk
        self.decode_rounds += 1
        self.decode_round_s += time.perf_counter() - t0
        self._lengths[self._lengths > 0] += chunk

        for s in active:
            req = self._requests[self._slot_req[s]]
            new = [int(t) for t in tokens[:, s]]
            if self.eos_token_id is not None and self.eos_token_id in new:
                # EOS inside the chunk: keep it, drop the tail (its page room
                # frees with the slot).
                new = new[: new.index(self.eos_token_id) + 1]
                req.max_new_tokens = len(req.generated) + len(new)
            req.generated.extend(new)
            self.stats["tokens_generated"] += len(new)
        self._finish_ready()
        return bool(self._requests) or self.sched.num_waiting > 0

    def _decoding_slots(self) -> list[int]:
        return [s for s in range(self.slots)
                if self._slot_req[s] != -1 and s not in self._prefilling]

    def _finish_ready(self):
        for s in range(self.slots):
            rid = self._slot_req[s]
            if rid == -1:
                continue
            req = self._requests[rid]
            done = len(req.generated) >= req.max_new_tokens
            if self.eos_token_id is not None and req.generated:
                done = done or req.generated[-1] == self.eos_token_id
            if not done:
                continue
            self.sched.release_slot(s, requeue=False)
            self._done[rid] = req.generated
            self.stats["requests_finished"] += 1
            req.finish_t = time.monotonic()
            self.metrics.append({
                "req_id": rid,
                "prompt_len": len(req.prompt),
                "new_tokens": len(req.generated),
                "ttft_s": None if req.first_token_t is None else req.first_token_t - req.submit_t,
                "e2e_s": req.finish_t - req.submit_t,
            })
            del self._requests[rid]
            self._slot_req[s] = -1
            self._set_length(s, 0)
            self._clear_table(s)

    # ---- admission ----

    def _admit(self):
        before = [self.sched.slot_id(s) for s in range(self.slots)]
        if self.sched.admit() == 0:
            return
        whole = []
        for s in range(self.slots):
            rid = self.sched.slot_id(s)
            if rid == -1 or before[s] != -1:
                continue
            self._slot_req[s] = rid
            if self.prefill_chunk > 0:
                # Chunked admission: chunks advance one per engine round,
                # interleaved with decode.
                self.stats["prefills"] += 1
                self._requests[rid].generated = []
                self._prefilling[s] = 0
                self._sync_table(s)
                self._set_length(s, 0)
            else:
                whole.append(s)
        # Longest prompts first, so each group pads little.
        whole.sort(key=lambda s: -len(self._requests[self._slot_req[s]].prompt))
        g = self.prefill_group
        self._prefill_groups([whole[i: i + g] for i in range(0, len(whole), g)])

    def _prefill_groups(self, groups: list[list[int]]):
        """Whole-prompt admission: one prefill forward per group, then the
        first tokens of the whole wave in one transfer. Recompute semantics
        after preemption: restarting from the prompt replays the same tokens
        (sampling is keyed by request and position)."""
        firsts, admitted = [], []
        for slots in groups:
            reqs = [self._requests[self._slot_req[s]] for s in slots]
            plens = np.array([len(r.prompt) for r in reqs], np.int32)
            ids = np.zeros((len(slots), int(plens.max())), np.int64)
            for i, (s, req) in enumerate(zip(slots, reqs)):
                self.stats["prefills"] += 1
                req.generated = []
                ids[i, : plens[i]] = req.prompt
                self._sync_table(s)
                self._set_length(s, 0)
            sub = dataclasses.replace(self.state, page_table=self._upload(self._table[slots]),
                                      lengths=self._upload(np.zeros(len(slots), np.int32)))
            plens_dev = self._upload(plens)
            logits, _ = forward_paged(self.params, self.cfg, self._upload(ids), sub,
                                      mode="prefill", valid_len=plens_dev)
            self.stats["device_calls"] += 1
            self.forwards["prefill"] += 1
            self._lengths[slots] = plens
            last = logits[torch.arange(len(slots), device=self.device), plens_dev.long() - 1]
            firsts.append(self._sample_first(last, [r.req_id for r in reqs]))
            admitted += list(zip(slots, reqs))
        if admitted:
            self._take_first_tokens(admitted, torch.cat(firsts))

    def _advance_prefills(self):
        """Write and attend one prompt chunk for every chunk-admitting slot
        in a single extend forward. Each slot's length stays 0 in the decode
        state until its whole prompt is in (so decode rounds mask it);
        progress lives on the host. The last chunk is padded: padded rows
        write K/V past the prompt, which per-row causality keeps invisible to
        real rows and decode overwrites before reading."""
        slots = sorted(self._prefilling)
        if not slots:
            return
        c = self.prefill_chunk
        ids = np.zeros((len(slots), c), np.int64)
        progress = np.zeros((len(slots),), np.int32)
        for j, s in enumerate(slots):
            req = self._requests[self._slot_req[s]]
            p = self._prefilling[s]
            chunk_tokens = req.prompt[p: p + c]
            ids[j, : len(chunk_tokens)] = chunk_tokens
            progress[j] = p
        sub = dataclasses.replace(self.state, page_table=self._upload(self._table[slots]),
                                  lengths=self._upload(progress))
        logits, _ = forward_paged(self.params, self.cfg, self._upload(ids), sub, mode="extend")
        self.stats["device_calls"] += 1
        self.forwards["extend"] += 1

        done, rows, cols = [], [], []
        for j, s in enumerate(slots):
            req = self._requests[self._slot_req[s]]
            p = self._prefilling[s] + c
            plen = len(req.prompt)
            if p < plen:
                self._prefilling[s] = p
                continue
            # Admission complete: publish the real length, sample token 0
            # from the last real row (in-chunk index plen - 1 - (p - c)).
            del self._prefilling[s]
            self._set_length(s, plen)
            done.append((s, req))
            rows.append(j)
            cols.append(plen - 1 - (p - c))
        if done:
            last = logits[torch.tensor(rows, device=self.device),
                          torch.tensor(cols, device=self.device)]
            self._take_first_tokens(done, self._sample_first(last, [r.req_id for _, r in done]))

    def _sample_first(self, last_logits, rids) -> torch.Tensor:
        seeds = self._upload(np.array([self._req_seed(r) for r in rids], np.int64))
        return sample_keyed(last_logits, self.sampling, seeds, torch.zeros_like(seeds))

    def _take_first_tokens(self, admitted, firsts: torch.Tensor):
        """Bring an admission wave's first tokens to the host (one transfer)
        and count each against its request's budget and pages."""
        firsts = firsts.cpu().numpy()
        now = time.monotonic()
        for (s, req), tok in zip(admitted, firsts):
            req.generated.append(int(tok))
            if req.first_token_t is None:
                req.first_token_t = now
            self.stats["tokens_generated"] += 1
            self.sched.step_slot(s)
            self._sync_table(s)

    # ---- host state ----

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: through pinned memory and
        without a wait on the card, or a copy on the CPU."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _req_seed(self, rid: int) -> int:
        """Per-request sampling seed, stable across preemption replay."""
        return (self.seed * 1_000_003 + rid) & 0x7FFFFFFF

    def _sync_table(self, slot: int):
        rid = self._slot_req[slot]
        if rid != -1:
            self._table[slot] = self.sched.table_row(rid)

    def _set_length(self, slot: int, value: int):
        self._lengths[slot] = value

    def _clear_table(self, slot: int):
        """Point a freed slot's page-table row at the null page."""
        self._table[slot] = 0

    def _evict(self, slot: int, failed: bool = False):
        rid = self._slot_req[slot]
        if rid == -1:
            return
        if failed:
            self._failed.append(rid)
            self.stats["requests_failed"] += 1
            del self._requests[rid]
        self._prefilling.pop(slot, None)
        self._slot_req[slot] = -1
        self._set_length(slot, 0)
        self._clear_table(slot)

    def _drain_unservable(self) -> bool:
        """No slot active but requests wait: admit and prefill them one by
        one, or, when nothing is admissible into an empty batch (a prompt
        larger than the whole pool), report them unservable."""
        before = [self.sched.slot_id(s) for s in range(self.slots)]
        if self.sched.admit() > 0:
            new = [s for s in range(self.slots)
                   if self.sched.slot_id(s) != -1 and before[s] == -1]
            for s in new:
                self._slot_req[s] = self.sched.slot_id(s)
            self._prefill_groups([[s] for s in new])
            return True
        return False


class _PyScheduler:
    """Pure-Python twin of csrc/page_allocator.cpp::Scheduler, kept in
    lockstep with it (tests/test_torch_paged_attention.py), without the
    prefix-cache grants and page pins (ROADMAP A7b)."""

    def __init__(self, num_pages, page_size, pages_per_seq, slots):
        self.alloc = PageAllocator(num_pages, page_size, pages_per_seq)
        self.slots = slots
        # (id, plen, max_new, priority, seq); admission picks highest
        # priority then FIFO.
        self.waiting: list[tuple] = []
        self.running: dict[int, list] = {}  # slot -> [id, plen, max, gen, pri, seq]
        self.next_seq = 0
        self.stalled = False
        self.pages_per_seq = pages_per_seq

    def submit(self, rid, plen, max_new, priority=0):
        self.waiting.append((rid, plen, max_new, priority, self.next_seq))
        self.next_seq += 1

    def _next_waiting(self):
        best = -1
        for i, (_, _, _, pri, seq) in enumerate(self.waiting):
            if best == -1 or (pri, -seq) > (self.waiting[best][3], -self.waiting[best][4]):
                best = i
        return best

    def admit(self):
        if self.stalled:
            return 0
        n = 0
        for s in range(self.slots):
            if not self.waiting or s in self.running:
                continue
            widx = self._next_waiting()
            rid, plen, max_new, pri, seq = self.waiting[widx]
            if not self.alloc.allocate(rid, 0, plen):
                self.alloc.release(rid)
                break
            self.waiting.pop(widx)
            self.running[s] = [rid, plen, max_new, 0, pri, seq]
            n += 1
        return n

    def step_slot(self, s):
        if s not in self.running:
            return -1
        rid, plen, max_new, gen = self.running[s][:4]
        if not self.alloc.allocate(rid, plen + gen, 1):
            self.stalled = True
            return 0
        self.stalled = False
        self.running[s][3] += 1
        return 1

    def finished(self, s):
        return s in self.running and self.running[s][3] >= self.running[s][2]

    def release_slot(self, s, requeue=False):
        if s not in self.running:
            return
        rid, plen, max_new, _, pri, seq = self.running.pop(s)
        self.alloc.release(rid)
        if requeue:
            # The victim keeps its FIFO standing within its priority class.
            self.waiting.insert(0, (rid, plen, max_new, pri, seq))
        else:
            self.stalled = False

    def preempt_youngest(self):
        """Lowest priority first, youngest arrival within it."""
        if len(self.running) <= 1:
            return -1
        victim = -1
        for s in sorted(self.running, reverse=True):
            if victim == -1 or (self.running[s][4], -self.running[s][5]) < (
                self.running[victim][4], -self.running[victim][5]
            ):
                victim = s
        self.release_slot(victim, requeue=True)
        return victim

    def slot_id(self, s):
        return self.running[s][0] if s in self.running else -1

    def slot_generated(self, s):
        return self.running[s][3] if s in self.running else -1

    @property
    def num_waiting(self):
        return len(self.waiting)

    @property
    def num_free_pages(self):
        return self.alloc.num_free

    def table_row(self, rid):
        return self.alloc.table_row(rid)
