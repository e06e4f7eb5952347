"""HTTP inference server over the KV-cache Generator (counterpart of
neko_tpu/serving/server.py).

A stdlib `http.server` JSON API with MICRO-BATCHING: concurrent requests
with compatible decode parameters are coalesced into one generation call,
padded to a power-of-two batch.  With `continuous_slots` > 0, plain
/v1/generate requests (no beams, no speculation, top_k == 0) join the
continuous-batching engine instead (serving/continuous.py), which also
streams their tokens; everything else keeps the coalescing path.

Endpoints:
  GET  /healthz       -> {"status": "ok", "model": {...}}
  GET  /metrics       -> request / response / error / token counters, and
                         the engine's under "continuous"
  POST /v1/generate   -> {"tokens": [...]} for {"text": [ids], "max_new_tokens": N,
                         "deterministic": bool, "temperature"/"top_k"/"top_p",
                         "stop": [ids], "num_beams": B, "speculative": true |
                         "lookup" | "draft", "speculate_k": K, "stream": bool};
                         a stream is chunked NDJSON: {"tokens": [...]} lines,
                         then {"done": true, ...} or {"error": ...}
  POST /v1/action     -> {"action": ...} for {"continuous_obs"/"discrete_obs"/
                         "images": ..., "action_kind": "continuous"|"discrete",
                         "action_tokens": N[, "num_actions": M | "action_nvec": [...]]}

Run it with `python -m neko_tpu_torch.cli.serve`.

Over a 'model' axis of ranks (tensor-parallel serving, one process a rank)
the ranks run every Generator call in lockstep.  Rank 0 owns HTTP: its
server holds a `LockstepGenerator`, which broadcasts each call's host-side
arguments (a method name, examples, numbers, numpy arrays) to the other
ranks before it runs the call, one call at a time across the server's
threads.  Each other rank runs a `Follower`, which receives the calls and
replays them on its own Generator.  Device state (the caches, the engine's
slots) stays on its rank and is never sent: the engine's state and the
draft Generator travel as references, a `torch.Generator` as its seed (the
follower seeds one of its own alike on first sight).  Every rank gathers
the same logits, so every rank draws the same tokens.  `close()` sends the
shutdown sentinel that ends the followers' loops.

The calls travel on a gloo group of their own whose broadcasts wait
`CALL_WAIT`: a follower spends every idle spell of the server inside one
broadcast, and the default group's timeout (minutes) would end it there.
After each call the ranks tally its outcome over a second gloo group
(`multihost.tally`, 60 s).  When every rank succeeded the call's result
stands; when every rank raised, rank 0 reports the error to its client and
serving goes on (the followers log it).  Anything else (some ranks raised,
or a rank did not report) is a `LockstepError`: the ranks' states may
differ, so rank 0's server stops (its `fault` names why, and the serve CLI
exits with it) and the followers raise it.  A rank that fails inside one of
the model's own collectives leaves its peers waiting there until the
default group's timeout ends them.
"""

from __future__ import annotations

import datetime
import json
import queue
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from neko_tpu_torch.inference.generator import _check_sampling_args
from neko_tpu_torch.parallel.multihost import agree_group, broadcast_object, tally


# the Generator methods a server calls: what the ranks run in lockstep
LOCKSTEP_CALLS = ("generate_batch", "generate_beam", "generate_spec", "generate_spec_draft",
                  "predict_control_batch", "engine_init", "engine_admit", "engine_chunk",
                  "engine_spec_chunk")


# how long a follower waits for rank 0's next call: a server may stand idle
# for days between requests
CALL_WAIT = datetime.timedelta(days=365)


class LockstepError(RuntimeError):
    """The ranks of a lockstep server did not all succeed or all fail at
    one call, or one did not report: their states may differ."""


def _channels():
    """(the call channel, the outcome group) of a lockstep server: gloo
    groups of every rank, each rank making them at once (a collective).
    Every call is made of CPU bytes, whichever backend the model's
    collectives use."""
    import torch.distributed as dist

    return dist.new_group(backend="gloo", timeout=CALL_WAIT), agree_group()


def _settle(name: str, failed: bool, outcomes) -> Optional[str]:
    """The ranks' tally of a call's outcome: None when every rank succeeded
    or every one raised, else what went wrong."""
    both = tally(failed, outcomes)
    if both is None:
        return f"a rank did not report the outcome of {name} (down, or stuck in it)"
    any_failed, all_failed = both
    if any_failed and not all_failed:
        return f"{name} raised on some ranks and succeeded on others"
    return None


class _Ref(tuple):
    """A stand-in in a broadcast call: ("state",), ("draft",) or ("rng",
    index, seed)."""


class LockstepGenerator:
    """Rank 0's Generator under a 'model' group of ranks: each call of a
    LOCKSTEP_CALLS method is broadcast to the `Follower`s, then run; other
    attributes are the Generator's.  `draft`: the draft Generator a server
    passes to `generate_spec_draft`."""

    def __init__(self, generator, draft=None):
        self._gen, self._draft = generator, draft
        self._lock = threading.Lock()
        self._state = None  # the engine's state (engine_init's result)
        self._rngs: Dict[int, int] = {}  # id of a torch.Generator -> its index
        self._calls, self._outcomes = _channels()  # the Followers make theirs at once
        self.fault: Optional[str] = None  # once set, every call raises LockstepError
        self.on_fault = None  # called with the fault when it is found (the server stops)

    def __getattr__(self, name):
        attr = getattr(self._gen, name)
        if name not in LOCKSTEP_CALLS:
            return attr

        def call(*args, **kw):
            with self._lock:
                if self.fault is not None:
                    raise LockstepError(self.fault)
                broadcast_object((name, self._encode(args), self._encode(kw)), self._calls)
                out = err = None
                try:
                    out = attr(*args, **kw)
                except Exception as e:  # noqa: BLE001 -- tallied, then raised
                    err = e
                self.fault = _settle(name, err is not None, self._outcomes)
                if self.fault is not None:
                    if self.on_fault is not None:
                        self.on_fault(self.fault)
                    raise LockstepError(self.fault) from err
                if err is not None:  # every rank raised it: the caller reports it
                    raise err
                if name == "engine_init":
                    self._state = out
                return out

        return call

    def _encode(self, obj):
        import torch

        if self._state is not None and obj is self._state:
            return _Ref(("state",))
        if self._draft is not None and obj is self._draft:
            return _Ref(("draft",))
        if isinstance(obj, torch.Generator):
            i = self._rngs.setdefault(id(obj), len(self._rngs))
            return _Ref(("rng", i, obj.initial_seed()))
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._encode(x) for x in obj)
        if isinstance(obj, dict):
            return {k: self._encode(v) for k, v in obj.items()}
        return obj

    def close(self) -> None:
        """End the followers' loops (once every caller is done; after a
        fault they have ended already)."""
        with self._lock:
            if self.fault is None:
                broadcast_object(None, self._calls)


class Follower:
    """A rank other than 0 under a 'model' group: `run()` replays rank 0's
    Generator calls on this rank's Generator (and draft) until rank 0's
    server closes, and raises `LockstepError` if the ranks' outcomes of a
    call differ.  A call that raised here is logged with its traceback."""

    def __init__(self, generator, draft=None):
        self.gen, self.draft = generator, draft
        self.calls = self.errors = 0
        self._calls, self._outcomes = _channels()  # rank 0 makes its own at once

    def run(self) -> None:
        import torch
        import torch.distributed as dist

        refs = {"draft": self.draft, "state": None}
        rngs: Dict[int, "torch.Generator"] = {}

        def decode(obj):
            if isinstance(obj, _Ref):
                if obj[0] != "rng":
                    return refs[obj[0]]
                if obj[1] not in rngs:  # seeded as rank 0's was before its first draw
                    rngs[obj[1]] = torch.Generator(device=self.gen.device).manual_seed(obj[2])
                return rngs[obj[1]]
            if isinstance(obj, (list, tuple)):
                return type(obj)(decode(x) for x in obj)
            if isinstance(obj, dict):
                return {k: decode(v) for k, v in obj.items()}
            return obj

        while True:
            msg = broadcast_object(None, self._calls)
            if msg is None:
                return
            name, args, kw = msg
            self.calls += 1
            out, failed = None, False
            try:
                out = getattr(self.gen, name)(*decode(args), **decode(kw))
            except Exception:  # noqa: BLE001 -- tallied with rank 0's outcome below
                failed = True
                self.errors += 1
                print(f"[neko-tpu-torch] rank {dist.get_rank()}: {name} raised",
                      file=sys.stderr, flush=True)
                traceback.print_exc()
            fault = _settle(name, failed, self._outcomes)
            if fault is not None:
                raise LockstepError(f"rank {dist.get_rank()} stops: {fault}")
            if name == "engine_init" and not failed:
                refs["state"] = out


class _Pending:
    __slots__ = ("payload", "event", "result", "error", "key", "status",
                 "cancelled", "stream_q")

    def __init__(self, payload: Dict, key):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.status = 200
        self.cancelled = False
        self.key = key
        # a streaming request's events from the continuous engine:
        # ("tokens", [ids]) / ("done", result) / ("error", msg)
        self.stream_q: Optional[queue.Queue] = None


def _opt(payload: Dict, key: str, default, cast):
    """Explicit-None coercion: 0 is a VALUE (rejected downstream where
    invalid), not an absent field."""
    v = payload.get(key)
    return default if v is None else cast(v)


def _next_pow2(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _pad_pow2(examples: List[Dict]) -> List[Dict]:
    """Pad a coalesced group to a power-of-two batch size by repeating the
    last example, bounding the set of batch shapes a long-lived server runs
    to {1, 2, 4, ...}.  Pad rows come after the real rows; callers read the
    real rows only."""
    n = _next_pow2(len(examples), lo=1)
    return list(examples) + [examples[-1]] * (n - len(examples))


def _truncate_at_stop(ids: List[int], stop) -> List[int]:
    """Cut the response at the first stop id (exclusive)."""
    if not stop:
        return ids
    stops = set(int(s) for s in stop)
    for i, t in enumerate(ids):
        if t in stops:
            return ids[:i]
    return ids


def _example_from_payload(p: Dict) -> Dict:
    ex = {}
    if "text" in p:
        ex["text"] = [int(t) for t in p["text"]]
    for k in ("continuous_obs", "discrete_obs", "images",
              "continuous_actions", "discrete_actions"):
        if k in p:
            dt = np.int32 if k.startswith("discrete") else np.float32
            ex[k] = np.asarray(p[k], dt)
    if not ex:
        raise ValueError("request carries no model inputs")
    return ex


class NekoServer:
    """Owns the request queue, the batching worker, and the HTTP server."""

    def __init__(
        self,
        generator,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 8,
        batch_window_ms: float = 5.0,
        max_tokens: int = 256,
        max_beams: int = 8,
        continuous_slots: int = 0,
        continuous_chunk: int = 8,
        continuous_spec_k: int = 0,
        continuous_spec_threshold: int = 48,
        draft_generator=None,
        request_timeout: float = 120.0,
    ):
        """`continuous_slots` > 0 serves plain /v1/generate requests through
        the continuous-batching engine (`continuous_chunk` tokens a call,
        adaptive prompt-lookup speculation with `continuous_spec_k` > 0).
        `draft_generator`: a smaller Generator of the same token space;
        {"speculative": true} then verifies its proposals
        (generate_spec_draft) instead of prompt-lookup ones ("lookup" forces
        those)."""
        self.gen = generator
        self.draft = draft_generator
        self.max_batch = max_batch
        self.batch_window = batch_window_ms / 1000.0
        self.max_tokens = max_tokens
        self.request_timeout = request_timeout
        self.max_beams = min(max_beams, generator.cfg.token_space.text_tokens)
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run_worker, daemon=True)
        # advisory counters (GET /metrics); coalesced_calls counts the
        # coalescing worker's generation calls (one prefill each)
        self.stats = {"requests": 0, "responses": 0, "errors": 0, "tokens_out": 0,
                      "coalesced_calls": 0}
        self.fault: Optional[str] = None  # why a lockstep server stopped serving
        if isinstance(generator, LockstepGenerator):
            generator.on_fault = self._fail
        self._cont = None
        if continuous_slots > 0:
            from neko_tpu_torch.serving.continuous import ContinuousEngine

            self._cont = ContinuousEngine(
                generator, slots=continuous_slots, chunk=continuous_chunk,
                speculate_k=continuous_spec_k, spec_threshold=continuous_spec_threshold)

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj: Dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    m = dict(server.stats)
                    if server._cont is not None:
                        m["continuous"] = server._cont.metrics()
                    return self._json(200, m)
                if self.path != "/healthz":
                    return self._json(404, {"error": "not found"})
                cfg = server.gen.cfg
                self._json(200, {
                    "status": "ok",
                    "model": {
                        "embed_dim": cfg.embed_dim,
                        "layers": cfg.layers,
                        "heads": cfg.heads,
                        "context_len": cfg.context_len,
                        "kv_cache_dtype": cfg.kv_cache_dtype,
                    },
                })

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    return self._json(400, {"error": "invalid JSON"})
                if not isinstance(payload, dict):
                    return self._json(400, {"error": "payload must be a JSON object"})
                if self.path == "/v1/generate":
                    payload["_kind"] = "generate"
                elif self.path == "/v1/action":
                    payload["_kind"] = "action"
                else:
                    return self._json(404, {"error": "not found"})
                server.stats["requests"] += 1
                try:
                    result = server.submit(payload, timeout=server.request_timeout)
                except (ValueError, TypeError, KeyError, OverflowError) as e:
                    # raised BEFORE queueing: payload-induced, a client error
                    server.stats["errors"] += 1
                    return self._json(400, {"error": str(e)})
                if result.stream_q is not None:
                    return self._stream(result)
                if result.error is not None:
                    server.stats["errors"] += 1
                    return self._json(result.status, {"error": result.error})
                server.stats["responses"] += 1
                server.stats["tokens_out"] += len(result.result.get("tokens", ()))
                self._json(200, result.result)

            def _stream(self, req) -> None:
                """Chunked NDJSON: one {"tokens": [...]} line per engine
                chunk, then {"done": true, ...} (or {"error": ...})."""
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def line(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

                deadline = time.time() + server.request_timeout
                try:
                    while True:
                        try:
                            kind, val = req.stream_q.get(
                                timeout=max(0.1, deadline - time.time()))
                        except queue.Empty:
                            req.cancelled = True  # the engine frees the slot
                            server.stats["errors"] += 1
                            line({"error": "timed out"})
                            break
                        if kind == "tokens":
                            line({"tokens": val})
                        elif kind == "done":
                            server.stats["responses"] += 1
                            server.stats["tokens_out"] += len(val["tokens"])
                            line({"done": True, **val})
                            break
                        else:
                            server.stats["errors"] += 1
                            line({"error": val})
                            break
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    # the client went away mid-stream: free its slot rather
                    # than decode the rest for nobody
                    req.cancelled = True

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    # ------------------------------------------------------------ lifecycle
    @property
    def address(self):
        return self.httpd.server_address

    @property
    def coalesced_calls(self) -> int:
        return self.stats["coalesced_calls"]

    def start(self) -> "NekoServer":
        self._worker.start()
        if self._cont is not None:
            self._cont.start()
        self._serve_thread.start()
        return self

    def _fail(self, fault: str) -> None:
        """The ranks' states may differ: stop taking requests (the serve CLI
        then exits naming `fault`)."""
        self.fault = fault
        threading.Thread(target=self.httpd.shutdown, daemon=True).start()

    def close(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._worker.join(timeout=30)
        if self._cont is not None:
            self._cont.close()
        if isinstance(self.gen, LockstepGenerator):  # the other ranks stop too
            self.gen.close()
        # release any handler threads still waiting on queued requests
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            r.error, r.status = "server closing", 503
            r.event.set()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- requests
    def _prompt_len(self, payload: Dict) -> int:
        return self.gen.packer.pack_example(_example_from_payload(payload)).length

    def submit(self, payload: Dict, timeout: float = 120.0) -> _Pending:
        kind = payload["_kind"]
        use_cont = False
        if kind == "generate":
            want = _opt(payload, "max_new_tokens", 16, int)
            if not 1 <= want <= self.max_tokens:
                raise ValueError(
                    f"max_new_tokens must be in [1, {self.max_tokens}]"
                )
            top_k = _opt(payload, "top_k", 0, int)
            num_beams = _opt(payload, "num_beams", 1, int)
            if not 1 <= num_beams <= self.max_beams:
                raise ValueError(f"num_beams must be in [1, {self.max_beams}]")
            temperature = _opt(payload, "temperature", 1.0, float)
            top_p = _opt(payload, "top_p", 1.0, float)
            _check_sampling_args(temperature, top_k, top_p)
            if payload.get("stop") is not None:
                payload["stop"] = [int(s) for s in payload["stop"]]
            # requested length stays OUT of the key: requests differing only
            # in want coalesce into the shared pow2 bucket and each response
            # slices its own prefix
            key = (
                "generate",
                _next_pow2(want),
                bool(payload.get("deterministic", True)),
                temperature,
                top_k,
                top_p,
                num_beams,
            )
            S = self.gen.cfg.context_len
            if num_beams > 1:
                # beams run at the exact requested length (the winning
                # hypothesis depends on it) and must fit the context
                L = self._prompt_len(payload)
                if L + want > S:
                    raise ValueError(f"beam search needs prompt+max_new_tokens <= context "
                                     f"({L} + {want} > {S})")
                key = key + (want,)
            if payload.get("speculative"):
                # lossless speculative decoding, from the draft model when
                # the server has one, else prompt lookup; "lookup" / "draft"
                # force a mode
                if num_beams > 1:
                    raise ValueError("speculative excludes num_beams")
                mode = payload["speculative"]
                if mode not in (True, "lookup", "draft"):
                    raise ValueError("speculative must be true, 'lookup' or 'draft'")
                if mode == "draft" and self.draft is None:
                    raise ValueError("no draft model loaded (--draft_model_path)")
                spec_mode = ("draft" if mode == "draft" or (mode is True and self.draft)
                             else "lookup")
                if spec_mode == "lookup" and "text" not in payload:
                    raise ValueError("prompt-lookup speculation needs a text prompt")
                spec_k = _opt(payload, "speculate_k", 4, int)
                if not 1 <= spec_k <= 16:
                    raise ValueError("speculate_k must be in [1, 16]")
                if self._prompt_len(payload) + want + spec_k + 1 > S:
                    raise ValueError("speculative decode needs prompt + max_new_tokens "
                                     "+ speculate_k + 1 <= context")
                key = ("spec", spec_mode, want, spec_k,
                       bool(payload.get("deterministic", True)), temperature, top_k, top_p)
            # the engine's per-row knobs cover greedy / temperature / top-p /
            # stop / length; top_k, beams and speculation stay coalesced
            use_cont = (self._cont is not None and num_beams == 1
                        and not payload.get("speculative") and top_k == 0)
        elif kind == "action":
            action_kind = str(payload["action_kind"])
            if action_kind not in ("continuous", "discrete"):
                raise ValueError("action_kind must be continuous|discrete")
            action_tokens = int(payload["action_tokens"])
            if action_tokens < 1:
                raise ValueError("action_tokens must be >= 1")
            num_actions = _opt(payload, "num_actions", None, int)
            nvec = payload.get("action_nvec")
            if nvec is not None:
                nvec = tuple(int(n) for n in nvec)
                if len(nvec) != action_tokens or min(nvec) < 1:
                    raise ValueError(
                        "action_nvec needs action_tokens entries, each >= 1"
                    )
            if action_kind == "discrete":
                if nvec is None and num_actions is None:
                    raise ValueError("discrete actions require num_actions "
                                     "or action_nvec")
                if nvec is None and action_tokens != 1:
                    raise ValueError("discrete actions use action_tokens=1 "
                                     "(MultiDiscrete needs action_nvec)")
                if num_actions is not None and num_actions < 1:
                    raise ValueError("num_actions must be >= 1")
            key = (
                "action",
                action_kind,
                action_tokens,
                num_actions,
                nvec,
                bool(payload.get("deterministic", True)),
            )
        else:
            raise ValueError(f"unknown request kind {kind!r}")
        ex = _example_from_payload(payload)  # validate before queueing
        if kind == "action" and not any(
            "obs" in k or k == "images" for k in ex
        ):
            raise ValueError("action requests need an observation input")
        stream = bool(payload.get("stream"))
        if stream and not use_cont:
            raise ValueError("streaming needs continuous batching (--continuous_slots) and a "
                             "plain generate request (no beams / speculative / top_k)")
        req = _Pending(payload, key)
        if self._stop.is_set():
            req.error, req.status = "server closing", 503
            return req
        if stream:  # the handler writes the events as the engine's chunks land
            req.stream_q = queue.Queue()
            self._cont.submit(req)
            return req
        if use_cont:
            self._cont.submit(req)
        else:
            self._q.put(req)
        if not req.event.wait(timeout):
            req.cancelled = True  # worker will skip it
            req.error, req.status = "timed out", 504
        return req

    # --------------------------------------------------------------- worker
    def _run_worker(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.time() + self.batch_window
            while len(batch) < self.max_batch:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            groups: Dict[tuple, List[_Pending]] = {}
            for r in batch:
                if r.cancelled:  # handler already timed out and responded
                    continue
                groups.setdefault(r.key, []).append(r)
            for key, rs in groups.items():
                self.stats["coalesced_calls"] += 1
                try:
                    if key[0] == "generate":
                        self._serve_generate(key, rs)
                    elif key[0] == "spec":
                        self._serve_spec(key, rs)
                    else:
                        self._serve_action(key, rs)
                except Exception as e:  # noqa: BLE001 -- payloads were
                    # validated pre-queue, so this is a server fault: report
                    # it to every client of the group and keep serving
                    for r in rs:
                        r.error = f"{type(e).__name__}: {e}"
                        r.status = 500
                for r in rs:
                    r.event.set()

    def _serve_generate(self, key, rs: List[_Pending]) -> None:
        _, bucket, det, temp, top_k, top_p, num_beams = key[:7]
        ts = self.gen.cfg.token_space
        start, end = ts.start("text"), ts.end("text")
        examples = [_example_from_payload(r.payload) for r in rs]
        if num_beams > 1:  # at the exact requested length, which the key carries
            tokens, scores = self.gen.generate_beam(
                _pad_pow2(examples), max_new_tokens=key[7], start=start, end=end,
                num_beams=num_beams)
            for i, r in enumerate(rs):
                ids = (tokens[i, 0] - start).tolist()
                r.result = {"tokens": _truncate_at_stop(ids, r.payload.get("stop")),
                            "score": float(scores[i, 0]), "batched_with": len(rs) - 1}
            return
        # generate the bucket length, return each request's own prefix
        (tokens,) = self.gen.generate_batch(
            _pad_pow2(examples), max_new_tokens=bucket, start=start, end=end,
            deterministic=det, temperature=temp, top_k=top_k, top_p=top_p,
            return_logits=False,
        )
        for i, r in enumerate(rs):
            want = _opt(r.payload, "max_new_tokens", 16, int)
            ids = (tokens[i, :want] - start).tolist()
            r.result = {
                "tokens": _truncate_at_stop(ids, r.payload.get("stop")),
                "batched_with": len(rs) - 1,
            }

    def _serve_spec(self, key, rs: List[_Pending]) -> None:
        _, spec_mode, want, spec_k, det, temp, top_k, top_p = key
        ts = self.gen.cfg.token_space
        kw = dict(max_new_tokens=want, start=ts.start("text"), end=ts.end("text"),
                  speculate_k=spec_k, deterministic=det, temperature=temp, top_k=top_k,
                  top_p=top_p)
        examples = _pad_pow2([_example_from_payload(r.payload) for r in rs])
        if spec_mode == "draft":
            tokens, rounds = self.gen.generate_spec_draft(examples, self.draft, **kw)
        else:
            tokens, rounds = self.gen.generate_spec(examples, **kw)
        for i, r in enumerate(rs):
            ids = (tokens[i] - kw["start"]).tolist()
            r.result = {"tokens": _truncate_at_stop(ids, r.payload.get("stop")),
                        "rounds": int(rounds), "batched_with": len(rs) - 1}

    def _serve_action(self, key, rs: List[_Pending]) -> None:
        _, action_kind, action_tokens, num_actions, nvec, det = key
        examples = []
        for r in rs:
            ex = _example_from_payload(r.payload)
            slot = f"{action_kind}_actions"
            if slot not in ex:  # zero action slots, one per obs timestep
                obs = next(v for k, v in ex.items() if "obs" in k or k == "images")
                dt = np.float32 if action_kind == "continuous" else np.int32
                ex[slot] = np.zeros((len(obs), action_tokens), dt)
            examples.append(ex)
        actions = self.gen.predict_control_batch(
            _pad_pow2(examples), action_kind=action_kind,
            action_tokens=action_tokens, num_actions=num_actions,
            action_nvec=nvec, deterministic=det,
        )
        for r, a in zip(rs, actions):
            r.result = {
                "action": a if isinstance(a, int) else np.asarray(a).tolist(),
                "batched_with": len(rs) - 1,
            }
