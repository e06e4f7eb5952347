"""HTTP inference server over the KV-cache Generator (counterpart of
neko_tpu/serving/server.py, coalescing path).

A stdlib `http.server` JSON API with MICRO-BATCHING: concurrent requests
with compatible decode parameters are coalesced into one `generate_batch`
call, padded to a power-of-two batch.

Endpoints:
  GET  /healthz       -> {"status": "ok", "model": {...}}
  POST /v1/generate   -> {"tokens": [...]} for {"text": [ids], "max_new_tokens": N,
                         "deterministic": bool, "temperature"/"top_k"/"top_p",
                         "stop": [ids]}
  POST /v1/action     -> {"action": ...} for {"continuous_obs"/"discrete_obs"/
                         "images": ..., "action_kind": "continuous"|"discrete",
                         "action_tokens": N[, "num_actions": M | "action_nvec": [...]]}

Not yet ported, answered with 400: beam search ("num_beams" > 1),
speculative decoding ("speculative", prompt lookup or a draft model) and
streaming ("stream").  Continuous batching (`continuous_slots` > 0) is
refused when the server is built.

Run it with `python -m neko_tpu_torch.cli.serve`.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from neko_tpu_torch.inference.generator import _check_sampling_args


class _Pending:
    __slots__ = ("payload", "event", "result", "error", "key", "status",
                 "cancelled")

    def __init__(self, payload: Dict, key):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.status = 200
        self.cancelled = False
        self.key = key


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


class NotYetPorted(ValueError):
    pass


def _refuse_unported(payload: Dict) -> None:
    features = {
        "num_beams > 1 (beam search)": _opt(payload, "num_beams", 1, int) > 1,
        "speculative decoding": bool(payload.get("speculative")),
        "streaming": bool(payload.get("stream")),
    }
    for name, asked in features.items():
        if asked:
            raise NotYetPorted(f"{name} is not yet ported to neko_tpu_torch")


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
        continuous_slots: int = 0,
        request_timeout: float = 120.0,
    ):
        if continuous_slots > 0:
            raise NotYetPorted(
                "continuous batching (continuous_slots > 0) is not yet "
                "ported to neko_tpu_torch"
            )
        self.gen = generator
        self.max_batch = max_batch
        self.batch_window = batch_window_ms / 1000.0
        self.max_tokens = max_tokens
        self.request_timeout = request_timeout
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run_worker, daemon=True)
        # generate_batch / predict_control_batch calls made (one prefill
        # each); written by the worker thread only
        self.coalesced_calls = 0

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
                try:
                    result = server.submit(payload, timeout=server.request_timeout)
                except (ValueError, TypeError, KeyError, OverflowError) as e:
                    # raised BEFORE queueing: payload-induced, a client error
                    return self._json(400, {"error": str(e)})
                if result.error is not None:
                    return self._json(result.status, {"error": result.error})
                self._json(200, result.result)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    # ------------------------------------------------------------ lifecycle
    @property
    def address(self):
        return self.httpd.server_address

    def start(self) -> "NekoServer":
        self._worker.start()
        self._serve_thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._worker.join(timeout=30)
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
    def submit(self, payload: Dict, timeout: float = 120.0) -> _Pending:
        kind = payload["_kind"]
        if kind == "generate":
            _refuse_unported(payload)
            want = _opt(payload, "max_new_tokens", 16, int)
            if not 1 <= want <= self.max_tokens:
                raise ValueError(
                    f"max_new_tokens must be in [1, {self.max_tokens}]"
                )
            top_k = _opt(payload, "top_k", 0, int)
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
            )
        elif kind == "action":
            if payload.get("stream"):
                raise NotYetPorted("streaming is not yet ported to neko_tpu_torch")
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
        req = _Pending(payload, key)
        if self._stop.is_set():
            req.error, req.status = "server closing", 503
            return req
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
                self.coalesced_calls += 1
                try:
                    if key[0] == "generate":
                        self._serve_generate(key, rs)
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
        _, bucket, det, temp, top_k, top_p = key
        ts = self.gen.cfg.token_space
        start, end = ts.start("text"), ts.end("text")
        examples = [_example_from_payload(r.payload) for r in rs]
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
