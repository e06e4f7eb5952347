"""Continuous batching: requests join and leave a RUNNING decode loop
(counterpart of neko_tpu/serving/continuous.py).

* a fixed pool of `slots` cache rows decodes in lockstep, `chunk` tokens a
  call (`Generator.engine_chunk`);
* requests waiting when slots are free are prefilled into them between
  chunks (`Generator.engine_admit`, one prefill for all of them) and start
  decoding on the next chunk; the other rows never stop;
* a finished row frees its slot at once, and so does a request whose
  client went away (`cancelled`);
* greedy / temperature / top-p are per-row knobs, so greedy and sampled
  requests share one decode step;
* each row runs its exact requested length, cut at its first stop token.

With `speculate_k` > 0 the engine picks, for each call, between a plain
chunk and `chunk` prompt-lookup verify rounds (`engine_spec_chunk`): rounds
run while some active row still wants at least `spec_threshold` tokens and
no active row's write window could cross the context end.

The engine owns its thread: HTTP handler threads only enqueue requests,
and every device call runs on the engine's thread.  A failing call fails
the requests in flight (status 500).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from neko_tpu_torch.serving.server import _example_from_payload, _opt, _truncate_at_stop
from neko_tpu_torch.utils import trace


class _Slot:
    __slots__ = ("req", "want", "ids", "det", "temp", "top_p", "co", "sent", "prompt_len")

    def __init__(self, req, want, det, temp, top_p, prompt_len=0):
        self.req = req
        self.want = want
        self.ids: List[int] = []
        self.det = det
        self.temp = temp
        self.top_p = top_p
        self.co = 0    # most co-resident active slots seen
        self.sent = 0  # tokens already streamed
        self.prompt_len = prompt_len  # host copy of the row's starting position


class ContinuousEngine:
    """Owns the slot pool, the admission queue and the decode thread.  It
    takes the server's `_Pending` requests (payloads validated by
    NekoServer.submit): plain /v1/generate requests, no beams, no
    speculation, top_k == 0."""

    def __init__(self, generator, *, slots: int = 8, chunk: int = 8, seed: int = 0,
                 speculate_k: int = 0, lookup_ngram: int = 2, spec_threshold: int = 48):
        if slots < 1 or chunk < 1:
            raise ValueError("continuous batching needs slots >= 1 and chunk >= 1")
        self.gen = generator
        self.n_slots = slots
        self.chunk = chunk
        self.spec_k = int(speculate_k)
        self.ngram = int(lookup_ngram)
        self.spec_threshold = int(spec_threshold)
        # the engine's own sampling stream: the coalescing worker draws from
        # the Generator's on another thread
        self._rng = torch.Generator(device=generator.device).manual_seed(seed)
        ts = generator.cfg.token_space
        self.start_id, self.end_id = ts.start("text"), ts.end("text")
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._state = None  # made on the decode thread
        self._slots: List[Optional[_Slot]] = [None] * slots
        # advisory counters (GET /metrics): admissions counts the prefill
        # calls, admitted the requests they took; queue_wait_s sums those
        # requests' seconds from NekoServer.submit to leaving the queue;
        # prompt_tokens their packed lengths, prefill_tokens the rows x the
        # context_len every row is prefilled at
        self.stats = {"admitted": 0, "finished": 0, "chunks": 0, "tokens_out": 0,
                      "spec_chunks": 0, "plain_chunks": 0, "admissions": 0,
                      "queue_wait_s": 0.0, "prompt_tokens": 0, "prefill_tokens": 0}

    def metrics(self) -> Dict:
        return {
            **self.stats,
            "slots": self.n_slots,
            "active": sum(s is not None for s in self._slots),
            "queued": self._q.qsize(),
            "chunk": self.chunk,
            "speculate_k": self.spec_k,
            "spec_threshold": self.spec_threshold,
        }

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ContinuousEngine":
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
        for r in self._drain() + [s.req for s in self._slots if s is not None]:
            r.error, r.status = "server closing", 503
            if r.stream_q is not None:
                r.stream_q.put(("error", r.error))
            r.event.set()
        self._slots = [None] * self.n_slots

    def _drain(self):
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def submit(self, req) -> None:
        self._q.put(req)

    # --------------------------------------------------------------- loop
    def _want_spec(self, active: List[int]) -> bool:
        """Run verify rounds iff some active row still wants >=
        spec_threshold more tokens and no active row's write window could
        cross the context end (such a row would park in a spec round)."""
        S = self.gen.cfg.context_len
        some_long = False
        for b in active:
            s = self._slots[b]
            produced = len(s.ids)
            if s.prompt_len + produced + self.spec_k + 1 > S:
                return False
            if s.want - produced >= self.spec_threshold:
                some_long = True
        return some_long

    def _admit_waiting(self, block: bool = False) -> None:
        """Admit waiting requests into the free slots, all in one prefill;
        with `block`, wait briefly for a first one."""
        free = [b for b, s in enumerate(self._slots) if s is None]
        reqs = []
        while len(reqs) < len(free):
            try:
                req = (self._q.get(timeout=0.05) if block and not reqs
                       else self._q.get_nowait())
            except queue.Empty:
                break
            if not req.cancelled:
                reqs.append(req)
        if not reqs:
            return
        taken = time.monotonic()
        for req in reqs:
            trace.record("engine.queue", req.t_submit, taken, req.rid)
        try:
            self._admit(free[:len(reqs)], reqs, taken)
        except Exception as e:  # noqa: BLE001 -- a prefill fault fails these requests
            for req in reqs:
                self._fail(req, f"{type(e).__name__}: {e}")

    def _admit(self, slots: List[int], reqs, taken: float) -> None:
        with trace.span("engine.admit"):
            examples = [_example_from_payload(r.payload) for r in reqs]
            self._state = self.gen.engine_admit(self._state, slots, examples)
            for b, req, ex in zip(slots, reqs, examples):
                p = req.payload
                self._slots[b] = _Slot(
                    req, want=_opt(p, "max_new_tokens", 16, int),
                    det=bool(p.get("deterministic", True)),
                    temp=_opt(p, "temperature", 1.0, float), top_p=_opt(p, "top_p", 1.0, float),
                    # the spec policy keeps rounds away from rows near the context end
                    prompt_len=self.gen.packer.pack_example(ex).length if self.spec_k else 0)
        st = self.stats
        st["admissions"] += 1
        st["admitted"] += len(reqs)
        st["queue_wait_s"] += sum(taken - r.t_submit for r in reqs)
        st["prompt_tokens"] += self._state["admit_prompt_tokens"]
        st["prefill_tokens"] += len(reqs) * self.gen.cfg.context_len

    def _finish(self, b: int, ids: List[int]) -> None:
        s = self._slots[b]
        s.req.result = {"tokens": ids, "batched_with": s.co, "continuous": True}
        if s.req.stream_q is not None:
            s.req.stream_q.put(("done", s.req.result))
        s.req.event.set()
        self._slots[b] = None
        self.stats["finished"] += 1
        self.stats["tokens_out"] += len(ids)

    @staticmethod
    def _fail(req, msg: str) -> None:
        req.error, req.status = msg, 500
        if req.stream_q is not None:
            req.stream_q.put(("error", msg))
        req.event.set()

    def _loop(self) -> None:
        self._state = self.gen.engine_init(self.n_slots, speculate_k=self.spec_k)
        n = self.n_slots
        while not self._stop.is_set():
            self._admit_waiting(block=all(s is None for s in self._slots))
            active = [b for b, s in enumerate(self._slots) if s is not None]
            if not active:
                continue
            with trace.span("engine.bookkeep"):
                det = np.ones(n, bool)
                temp = np.ones(n, np.float32)
                top_p = np.ones(n, np.float32)
                for b in active:
                    s = self._slots[b]
                    det[b], temp[b], top_p[b] = s.det, s.temp, s.top_p
                    s.co = max(s.co, len(active) - 1)
                run_spec = self.spec_k > 0 and self._want_spec(active)
            try:
                with trace.span("engine.chunk"):
                    if run_spec:
                        chunks, advs, self._state = self.gen.engine_spec_chunk(
                            self._state, rounds=self.chunk, start=self.start_id,
                            end=self.end_id, K=self.spec_k, ngram=self.ngram, det=det,
                            temp=temp, top_p=top_p, generator=self._rng)
                        self.stats["spec_chunks"] += 1
                    else:
                        toks, self._state = self.gen.engine_chunk(
                            self._state, n_steps=self.chunk, start=self.start_id,
                            end=self.end_id, det=det, temp=temp, top_p=top_p,
                            generator=self._rng)
                        self.stats["plain_chunks"] += 1
                self.stats["chunks"] += 1
            except Exception as e:  # noqa: BLE001 -- a device fault fails the requests
                for b in active:  # in flight rather than hanging their handlers
                    self._fail(self._slots[b].req, f"{type(e).__name__}: {e}")
                    self._slots[b] = None
                continue
            with trace.span("engine.bookkeep"):
                for b in active:
                    s = self._slots[b]
                    if s.req.cancelled:  # the client went away or timed out
                        self._slots[b] = None
                        continue
                    if run_spec:
                        for r in range(self.chunk):
                            s.ids.extend(int(t) - self.start_id
                                         for t in chunks[b, r, :int(advs[b, r])])
                    else:
                        s.ids.extend(int(t) - self.start_id for t in toks[b])
                    ids = s.ids[:s.want]
                    cut = _truncate_at_stop(ids, s.req.payload.get("stop"))
                    done = len(cut) < len(ids) or len(ids) >= s.want
                    if s.req.stream_q is not None and len(cut) > s.sent:
                        # stream only confirmed tokens: a stop cut applies within
                        # the chunk that produced it
                        s.req.stream_q.put(("tokens", cut[s.sent:]))
                        s.sent = len(cut)
                    if done:
                        self._finish(b, cut)
