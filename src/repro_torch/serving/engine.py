"""Continuous-batching serving engine for the (merged) model (counterpart of
``repro/serving/engine.py``).

The artifact decentralized training produces — after the paper's single
global merging — is ONE model; this module serves it with a three-op
split:

* **prefill(request)** — run the prompt at its exact length against a
  cache row already sized for the full decode horizon (``max_len``);
* **insert(row, slot)** — copy that B=1 cache row into slot ``s`` of the
  engine's persistent slotted cache: every cache leaf is laid out
  ``(n_rep, max_concurrency, ...)`` and a slot is row ``s`` of axis 1
  across all layers' KV rings, recurrent states and cross-attention
  caches (an encoder's rows padded to ``max_len`` at pos -1). The cache
  is allocated once and written in place (``copy_``, ``index_put_``) by
  insert and step, so decode never reallocates it (the reference donates
  the buffer to the same end);
* **step()** — ONE decode step over all slots at once, each at its own
  absolute position (per-slot position vectors), sampling one token per
  slot.

A host-side scheduler (:class:`ServingEngine`) admits queued requests into
free slots and retires slots on EOS / max-new, so heterogeneous-length
requests stream through one decode step — continuous batching. At
temperature 0 the engine gives the same tokens as running each request
alone through :func:`generate`: padded and retired slots only ever add
exact zeros to other rows' softmax sums (their keys sit at pos -1 or in
their own row). The products of a batch of C rows and of one row may round
differently (a matrix library picks its algorithm by shape), so the logits
of the two can differ in the last bits.

On the split serve route (``build_model(cfg, split=)``, the rank's pieces
``models.tensor_parallel.serve_pieces``) each data rank runs its own engine
over its share of the requests (the rows ``Split.data_rows`` gives it of
a batch of that many, cut by the caller); the model
ranks of one data rank run that engine in lockstep: their logits are
whole and equal on every model rank, so they sample the same tokens, and
insert and evict copy the rank's block of each cache leaf (its kv heads).
One process is the engine as it is.

Sampling masks logits columns >= ``cfg.vocab_size`` to -inf first: the LM
head projects to ``cfg.padded_vocab`` and the padding columns carry
random-init weights, so unmasked greedy/temperature sampling could emit
out-of-vocab ids. Temperature sampling draws from an explicit
``torch.Generator`` (``jax.random``'s bits cannot be reproduced).
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import extra_inputs
from repro_torch.telemetry import annotate, histogram_set, scope
from repro_torch.utils.tree import tree_leaves


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def mask_oov(logits, vocab_size: Optional[int]):
    """Mask the padded-vocab tail: columns >= vocab_size go to -inf."""
    if vocab_size is None or vocab_size >= logits.shape[-1]:
        return logits
    oov = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    return logits.masked_fill(oov, -torch.inf)


def sample_token(logits, gen: Optional[torch.Generator] = None,
                 temperature: float = 0.0, vocab_size: Optional[int] = None):
    """Greedy (temperature <= 0: argmax) or a categorical draw from ``gen``
    at ``temperature``; never an out-of-vocab id. logits (B, V) -> (B,)
    int32."""
    logits = mask_oov(logits, vocab_size)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


# ---------------------------------------------------------------------------
# the model's serving ops
# ---------------------------------------------------------------------------


def make_prefill_fn(model, max_len: Optional[int] = None):
    """(params, batch) -> (logits, caches of ``max_len`` slots), no
    autograd graph."""
    def prefill(params, batch):
        with torch.no_grad(), scope("serve.prefill"):
            return model.prefill(params, batch, max_len=max_len)
    return prefill


def make_decode_fn(model):
    """(params, caches, tokens, index) -> (logits, caches): one decode step
    that writes ``caches`` in place (the returned caches are the same
    tensors), no autograd graph."""
    def decode(params, caches, tokens, index):
        with torch.no_grad(), scope("serve.decode"):
            return model.decode_step(params, caches, tokens, index)
    return decode


def _tree_insert(caches, row, slot: int, key=None):
    """Copy a B=1 cache row (from prefill) into slot ``slot`` (axis 1 of
    every leaf) of the slotted cache, in place. Leaves whose trailing dims
    are shorter than the engine's are padded up — position leaves with -1
    so the padding stays masked, everything else with zeros."""
    if isinstance(caches, dict):
        for k in caches:
            _tree_insert(caches[k], row[k], slot, k)
        return
    r = row[:, 0].to(caches.dtype)
    if r.shape[1:] != caches.shape[2:]:
        pads = []
        for big, small in reversed(list(zip(caches.shape[2:],
                                             r.shape[1:]))):
            pads += [0, big - small]
        r = torch.nn.functional.pad(r, pads, value=-1 if key == "pos" else 0)
    caches[:, slot].copy_(r)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# one-shot generate (static batch)
# ---------------------------------------------------------------------------


def _refuse_unread(cfg, batch, what="model inputs"):
    """An input the model does not read would be ignored by its prefill
    while a patch prefix still shifted the decode positions, so it is
    refused: beside the tokens a model reads its ``extra_inputs`` (and an
    M-RoPE model its ``positions3``)."""
    reads = {"tokens", *extra_inputs(cfg, 0)}
    if cfg.attn.rope == "mrope":
        reads.add("positions3")
    unread = sorted(set(batch) - reads)
    if unread:
        raise ValueError(f"{what} {unread}: {cfg.name} reads only "
                         f"{sorted(reads)}")


@torch.no_grad()
def generate(model, params, batch, max_new: int, *, temperature: float = 0.0,
             rng: Optional[torch.Generator] = None,
             max_len: Optional[int] = None, eos_id: Optional[int] = None):
    """batch: model input dict with 'tokens' (B, S_prompt) (and a model's
    other inputs: the vlm's ``patch_embeds`` (B, P, d), whose P rows come
    before the prompt and count in its positions; the encoder-decoder's
    ``frame_embeds``). Returns (B, max_new) int32 numpy tokens.

    The tokens collect in a device buffer and are fetched ONCE at the end.
    Rows that hit ``eos_id`` keep emitting ``eos_id``; once every row is
    done the loop exits early (a host read of one flag a step, only when
    ``eos_id`` is set). An input the model does not read is refused."""
    _refuse_unread(model.cfg, batch)
    B, S = batch["tokens"].shape
    if "patch_embeds" in batch:  # absolute positions include the prefix
        S += batch["patch_embeds"].shape[1]
    total = max_len or (S + max_new)
    V = model.cfg.vocab_size
    logits, caches = make_prefill_fn(model, max_len=total)(params, batch)
    decode = make_decode_fn(model)
    dev = logits.device
    out = torch.full((B, max_new), eos_id if eos_id is not None else 0,
                     dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(max_new):
        tok = sample_token(logits, rng, temperature, vocab_size=V)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            done = done | (tok == eos_id)
        out[:, i] = tok
        if i + 1 == max_new or (eos_id is not None and bool(done.all())):
            break
        logits, caches = decode(params, caches, tok[:, None], S + i)
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------


@dataclass
class Request:
    """One serving request: prompt ids (unbatched), its token budget and
    the model's other inputs, unbatched (``patch_embeds`` (P, d),
    ``frame_embeds`` (S_src, d); numpy arrays or tensors)."""
    rid: Any
    tokens: np.ndarray
    max_new: int = 16
    extras: Dict[str, Any] = field(default_factory=dict)


class _Slot:
    __slots__ = ("req", "pos", "last", "out", "t_first")

    def __init__(self, req, pos, first_token, t_first=0.0):
        self.req = req
        self.pos = pos  # absolute position of the NEXT token to feed
        self.last = first_token
        self.out = [first_token]
        self.t_first = t_first  # perf_counter at first token (TTFT mark)


class ServingEngine:
    """Slotted continuous-batching engine (see module docstring).

    ``max_len`` bounds prefix + prompt + max_new per request (and an
    encoder's rows: the cross keys and values of a slot hold ``max_len``,
    a shorter encoder's padding at pos -1); the slotted
    cache holds ``max_concurrency`` such rows as one persistent set of
    tensors on the params' device, written in place. ``step()`` fetches
    exactly one (C,) token vector to the host per tick — the scheduler
    needs the ids to retire slots — and everything else stays on the
    device. ``rng`` is the ``torch.Generator`` temperature sampling draws
    from (on the params' device; default: seeded 0).

    **Telemetry.** Fixed-bucket latency histograms
    (:mod:`repro_torch.telemetry.latency`): ``ttft_s`` (submit → first
    token, covers queue + prefill), ``queue_wait_s`` (submit → admission),
    ``decode_step_s`` (one decode step incl. the (C,) token fetch) and
    ``per_token_s`` (a retired request's steady-state decode rate: time
    from its first token to retirement over tokens-1). The times are host
    clock readings after the card has finished the work they cover.
    :meth:`snapshot` exports counters + occupancy + histogram summaries;
    :meth:`reset` zeroes them WITHOUT touching live slots or queued work,
    so callers can discard warmup ticks. Passing ``events=`` an
    :class:`repro_torch.telemetry.EventLog` emits typed
    ``request_submit``/``request_admit``/``request_retire`` records.
    """

    def __init__(self, model, params, *, max_concurrency: int = 4,
                 max_len: int = 128, eos_id: Optional[int] = None,
                 temperature: float = 0.0,
                 rng: Optional[torch.Generator] = None, pad_id: int = 0,
                 events=None):
        self.model, self.params = model, params
        self.cfg = model.cfg
        self.device = tree_leaves(params)[0].device
        self.C, self.max_len = int(max_concurrency), int(max_len)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.pad_id = int(pad_id)
        self._gen = rng if rng is not None else torch.Generator(
            device=self.device).manual_seed(0)
        self.caches = model.init_cache(self.C, self.max_len,
                                       enc_len=self.max_len,
                                       device=self.device)
        self._empty_row = model.init_cache(1, self.max_len,
                                           enc_len=self.max_len,
                                           device=self.device)
        self._prefill = make_prefill_fn(model, max_len=self.max_len)
        self._decode = make_decode_fn(model)
        self._slots: List[Optional[_Slot]] = [None] * self.C
        self.queue: collections.deque = collections.deque()
        self.results: Dict[Any, np.ndarray] = {}
        self.stats = {"capacity": self.C, "ticks": 0, "live_slot_ticks": 0,
                      "admitted": 0, "retired": 0, "prefill_tokens": 0}
        self.hists = histogram_set(
            ("ttft_s", "queue_wait_s", "decode_step_s", "per_token_s"))
        self._t_submit: Dict[Any, float] = {}
        self.events = events

    # ------------------------------------------------------------ telemetry
    def snapshot(self) -> Dict[str, Any]:
        """Stats snapshot: counters + occupancy + latency summaries (and
        the raw sparse histograms, for cross-engine aggregation)."""
        return {**self.stats, "occupancy": self.occupancy,
                "latency": {k: h.summary() for k, h in self.hists.items()},
                "histograms": {k: h.to_dict() for k, h in
                               self.hists.items()}}

    def reset(self):
        """Zero counters and histograms; slots, queue and results are NOT
        touched — call after warmup so occupancy/latency cover only the
        measured window."""
        for k in ("ticks", "live_slot_ticks", "admitted", "retired",
                  "prefill_tokens"):
            self.stats[k] = 0
        for h in self.hists.values():
            h.reset()

    # ----------------------------------------------------- slot primitives
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def live_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def insert(self, row_caches, slot: int):
        """Copy a B=1 cache row into ``slot`` of the persistent cache."""
        with scope("serve.insert"):
            _tree_insert(self.caches, row_caches, int(slot))

    def evict(self, slot: int):
        """Reset ``slot`` to the empty row (pos=-1 everywhere) and free it."""
        self.insert(self._empty_row, slot)
        self._slots[slot] = None

    # ------------------------------------------------------------ schedule
    def submit(self, req: Request):
        self._t_submit[req.rid] = time.perf_counter()
        self.queue.append(req)
        if self.events is not None:
            self.events.emit(
                "request_submit", rid=req.rid,
                prompt_len=int(np.asarray(req.tokens).size),
                max_new=int(req.max_new))

    def _sample_host(self, logits) -> int:
        return int(sample_token(logits, self._gen, self.temperature,
                                vocab_size=self.cfg.vocab_size)[0])

    def _retire_if_done(self, slot: int):
        s = self._slots[slot]
        if len(s.out) >= s.req.max_new or (
                self.eos_id is not None and s.last == self.eos_id):
            self.results[s.req.rid] = np.asarray(s.out, np.int32)
            self._slots[slot] = None
            self.stats["retired"] += 1
            if len(s.out) > 1:
                self.hists["per_token_s"].record(
                    (time.perf_counter() - s.t_first) / (len(s.out) - 1))
            if self.events is not None:
                self.events.emit("request_retire", rid=s.req.rid,
                                 slot=slot, tick=self.stats["ticks"],
                                 tokens=len(s.out))

    def admit(self) -> int:
        """Prefill queued requests into free slots. Returns #admitted."""
        n = 0
        for slot in self.free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            t_sub = self._t_submit.pop(req.rid, None)
            if t_sub is not None:
                self.hists["queue_wait_s"].record(
                    time.perf_counter() - t_sub)
            _refuse_unread(self.cfg, {"tokens": None, **req.extras},
                           what=f"request {req.rid!r}: extras")
            prompt = np.asarray(req.tokens, np.int32).reshape(-1)
            batch = {"tokens": torch.from_numpy(prompt[None]).to(
                self.device)}
            for key, val in req.extras.items():
                batch[key] = torch.as_tensor(val).to(self.device)[None]
            prefix = (batch["patch_embeds"].shape[1]
                      if "patch_embeds" in batch else 0)
            start = prefix + prompt.shape[0]
            if start + req.max_new > self.max_len:
                raise ValueError(
                    f"request {req.rid!r}: prefix+prompt+max_new = "
                    f"{start + req.max_new} exceeds max_len={self.max_len}")
            if ("frame_embeds" in batch
                    and batch["frame_embeds"].shape[1] > self.max_len):
                raise ValueError(
                    f"request {req.rid!r}: {batch['frame_embeds'].shape[1]} "
                    f"encoder rows exceed the slots' max_len={self.max_len}")
            with annotate("serve.admit"):
                logits, row = self._prefill(self.params, batch)
                self.insert(row, slot)
                first = self._sample_host(logits)  # waits for the card
            t_first = time.perf_counter()
            if t_sub is not None:
                self.hists["ttft_s"].record(t_first - t_sub)
            self._slots[slot] = _Slot(req, start, first, t_first)
            self.stats["admitted"] += 1
            self.stats["prefill_tokens"] += int(start)
            n += 1
            if self.events is not None:
                self.events.emit("request_admit", rid=req.rid, slot=slot,
                                 tick=self.stats["ticks"])
            self._retire_if_done(slot)  # max_new == 1 / instant EOS
        return n

    def step(self):
        """One decode step over ALL slots. Returns [(rid, token), ...] for
        the live slots (in slot order)."""
        live = self.live_slots()
        tokens = np.full((self.C,), self.pad_id, np.int32)
        index = np.zeros((self.C,), np.int32)
        for i in live:
            tokens[i] = self._slots[i].last
            index[i] = self._slots[i].pos
        _sync(self.device)  # the tick's time is its own work's
        t0 = time.perf_counter()
        with annotate("serve.step"):
            tok_in = torch.from_numpy(tokens).to(self.device)
            idx_in = torch.from_numpy(index).to(self.device)
            logits, _ = self._decode(self.params, self.caches,
                                     tok_in[:, None], idx_in)
            with scope("serve.sample"):
                tok = sample_token(logits, self._gen, self.temperature,
                                   vocab_size=self.cfg.vocab_size)
            tok = tok.cpu().numpy()  # the ONE host fetch per tick: (C,)
        self.hists["decode_step_s"].record(time.perf_counter() - t0)
        self.stats["ticks"] += 1
        self.stats["live_slot_ticks"] += len(live)
        emitted = []
        for i in live:
            s = self._slots[i]
            s.pos += 1
            s.last = int(tok[i])
            s.out.append(s.last)
            emitted.append((s.req.rid, s.last))
            self._retire_if_done(i)
        return emitted

    @property
    def occupancy(self) -> float:
        """Live-slot-steps over capacity-steps across the run so far."""
        denom = self.stats["ticks"] * self.C
        return self.stats["live_slot_ticks"] / denom if denom else 0.0

    def serve(self, requests=None, *,
              stream: Optional[Callable[[Any, int], None]] = None):
        """Run until the queue and all slots drain. Returns {rid: tokens}
        (each (n,) int32, n <= max_new, ending at eos_id if hit)."""
        for r in requests or []:
            self.submit(r)
        while self.queue or self.live_slots():
            self.admit()
            if not self.live_slots():
                continue  # everything admitted retired instantly
            for rid, t in self.step():
                if stream is not None:
                    stream(rid, t)
        out, self.results = self.results, {}
        return out
