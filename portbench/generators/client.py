"""The closed-loop clients of a serving cell, in a process of their own:

    python3 portbench/generators/client.py --port P --traffic JSON --seed N
        --context S --text_tokens V --seconds W

`clients` connections (HTTP/1.1 keep-alive, one asyncio task each) post
greedy, unstreamed /v1/generate requests, each client its next request as
soon as its previous one is answered; request k is Requests(...)(k), taken
in order from one counter.  The load warms up for `warm_s`, then the
window of `--seconds` runs; after it no request is sent, and those in
flight get `drain_s` to finish.  Prints {"window_start": t} (time.monotonic,
which every process of the machine shares) at once, and at the end one
JSON line: {"records": [[k, sent, done, status, tokens], ...]} (status 0
and done null: no reply; a failed request's "tokens" is its error)."""

import argparse
import asyncio
import itertools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.generators.closed_loop import Requests  # noqa: E402


async def _post(reader, writer, body: bytes):
    writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                 b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n" % len(body)
                 + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    n = 0
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        if k.strip().lower() == "content-length":
            n = int(v)
    return status, await reader.readexactly(n)


async def _client(port, next_k, make, stop_at, records):
    reader = writer = None
    while time.monotonic() < stop_at:
        k = next_k()
        ids, want = make(k)
        body = json.dumps({"text": ids.tolist(), "max_new_tokens": want,
                           "deterministic": True}).encode()
        rec = [k, time.monotonic(), None, 0, None]  # a request never answered stays so
        records.append(rec)
        try:
            if writer is None:
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
            status, reply = await _post(reader, writer, body)
            body = json.loads(reply)
            tokens = body.get("tokens") if status == 200 else str(body.get("error"))[:300]
        except (OSError, asyncio.IncompleteReadError, ValueError, IndexError) as e:
            status, tokens, writer = 0, f"{type(e).__name__}: {e}"[:300], None
        rec[2:] = [time.monotonic(), status, tokens]
    if writer is not None:
        writer.close()


async def _main(a, t):
    make = Requests(t, a.context, a.text_tokens, a.seed)
    counter = itertools.count()
    start = time.monotonic()
    window_start = start + t["warm_s"]
    stop_at = window_start + a.seconds
    print(json.dumps({"window_start": window_start}), flush=True)
    records = []
    tasks = [asyncio.create_task(_client(a.port, lambda: next(counter), make, stop_at, records))
             for _ in range(t["clients"])]
    done, pending = await asyncio.wait(tasks, timeout=stop_at + t["drain_s"] - time.monotonic())
    for task in pending:
        task.cancel()
    for task in done:
        task.result()
    return records


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--traffic", required=True, help="the traffic mix as JSON text")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--context", type=int, required=True)
    ap.add_argument("--text_tokens", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args()
    t = json.loads(a.traffic)
    records = asyncio.run(_main(a, t))
    print(json.dumps({"records": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
