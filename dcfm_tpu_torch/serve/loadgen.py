"""Load generator + response classifier for the serving fleet.

The port's copy of ``dcfm_tpu/serve/loadgen.py``, with one addition:
``by_route`` reports the client-side p50/p99 of every route.

Drives a fleet with a seeded multi-threaded request mix and classifies
every single response - the chaos harness's ground truth.  The
classification contract (the acceptance criterion of the serve chaos
sweep) is:

* **ok**: HTTP 200 with a well-formed JSON body (optionally checked
  bitwise by the caller's ``expect`` hook);
* **typed**: an explicit JSON error the server MEANT to send - 400,
  404, 413, 429 (+ Retry-After), 503 (shed / corrupt / io-retry), 504
  (deadline).  Overload and chaos make these NORMAL; they are counted,
  never failed;
* **untyped**: anything else - a 500, a non-JSON body, a missing error
  field.  The sweep asserts this list is EMPTY: chaos may slow or
  reject a request but must never leak a stack trace or a half
  response;
* **dropped**: a request whose CONNECTION kept dying past the retry
  budget.  A worker SIGKILL mid-request resets its in-flight
  connections - that is what ``SO_REUSEPORT`` failover is for: the
  retry reconnects, the kernel routes it to a live worker, and the
  request completes.  ``dropped`` therefore counts requests the FLEET
  (not one worker) failed to answer; the sweep asserts 0.

Every thread also tracks the ``X-DCFM-Artifact-Generation`` header:
within a thread (sequential requests) the generation must never
decrease across a hot-swap - ``generation["violations"]`` counts
regressions and the sweep asserts 0.

Pure stdlib (urllib + sockets): the generator must not depend on the
server's own code paths for its verdicts.  ``run_load`` is the library
entry the tests and ``chip_smoke.py`` call in-process.

The slow-loris client (``slow_clients > 0``) opens a connection, dribbles HALF a request, and holds the socket
open.  Against a server without per-connection socket timeouts each
such client parks a handler thread forever (and stalls SIGTERM drain);
with ``io_timeout`` the server must shed the connection and keep the
real traffic flowing.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request

# statuses the server sends ON PURPOSE, with a JSON error body
TYPED_STATUSES = (400, 404, 413, 429, 503, 504)


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def _one_request(base: str, path: str, timeout: float):
    """-> (status, headers dict, parsed body or None).  Raises OSError
    (incl. socket.timeout / ConnectionResetError) on transport failure;
    HTTP error statuses are RETURNED, not raised."""
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read())
        except ValueError:
            body = None
        return e.code, dict(e.headers), body
    except http.client.HTTPException as e:
        # a worker SIGKILLed mid-write tears the status line or body
        # (IncompleteRead / RemoteDisconnected): same transport-failure
        # class as a connection reset, same retry
        raise OSError(f"torn response: {e!r}") from None
    except urllib.error.URLError as e:
        # unwrap to the transport error so the caller's retry loop sees
        # one exception family
        reason = getattr(e, "reason", e)
        if isinstance(reason, OSError):
            raise reason from None
        raise OSError(str(reason)) from None


def _slow_loris(host: str, port: int, hold_s: float, stop) -> None:
    """Half a request, then silence: the handler-thread-parking client
    the per-connection io_timeout exists for."""
    try:
        with socket.create_connection((host, port), timeout=5.0) as s:
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: loris\r\n")
            # never send the terminating CRLF; just squat on the socket
            deadline = time.monotonic() + hold_s
            while time.monotonic() < deadline and not stop.is_set():
                time.sleep(0.05)
    except OSError:
        pass    # server shed us (that is the point) or fleet is gone


def run_load(base: str, *, threads: int = 8, requests_per_thread: int = 50,
             seed: int = 0, p: int = 24, retries: int = 6,
             timeout: float = 10.0, slow_clients: int = 0,
             slow_hold_s: float = 2.0, expect=None,
             route_mix=(("entry", 6), ("block", 1), ("interval", 1),
                        ("healthz", 1))) -> dict:
    """Drive ``base`` and classify every response; see the module
    docstring for the contract.  ``expect(kind, path, body, generation)``
    is an optional per-200 hook returning an error string (or None) -
    the bitwise-correctness check of the hot-swap tests; its failures
    land in ``value_errors``.
    """
    host, port = base.split("//", 1)[1].rsplit(":", 1)
    port = int(port)
    lock = threading.Lock()
    out = {"requests": 0, "ok": 0, "typed": {}, "untyped": [],
           "dropped": 0, "retries": 0, "value_errors": [],
           "shed": 0, "rejected_429": 0,
           "generation": {"min": None, "max": None, "violations": 0}}
    latencies = []
    by_route = {}
    routes = [kind for kind, weight in route_mix for _ in range(weight)]

    def _path(rng, kind):
        if kind == "healthz":
            return "/healthz"
        i, j = rng.randrange(p), rng.randrange(p)
        if kind == "entry":
            return f"/v1/entry?i={i}&j={j}"
        if kind == "interval":
            return f"/v1/interval?i={i}&j={j}"
        lo = rng.randrange(max(1, p - 4))
        return f"/v1/block?rows={lo}:{min(p, lo + 4)}&cols={lo}:{min(p, lo + 4)}"

    def worker(t):
        rng = random.Random(f"serve-load:{seed}:{t}")
        last_gen = -1
        for _ in range(requests_per_thread):
            kind = rng.choice(routes)
            path = _path(rng, kind)
            status = headers = body = None
            used_retries = 0
            t0 = time.monotonic()
            for attempt in range(retries + 1):
                try:
                    status, headers, body = _one_request(base, path,
                                                         timeout)
                    break
                except OSError:
                    # transport death (worker killed mid-request, slow
                    # socket shed, ...): reconnect - SO_REUSEPORT lands
                    # the retry on a live worker
                    used_retries += 1
                    time.sleep(0.02 * (attempt + 1))
            ms = (time.monotonic() - t0) * 1e3
            with lock:
                out["requests"] += 1
                out["retries"] += used_retries
                latencies.append(ms)
                by_route.setdefault(kind, []).append(ms)
                if status is None:
                    out["dropped"] += 1
                    continue
                gen_s = headers.get("X-DCFM-Artifact-Generation")
                gen = int(gen_s) if gen_s is not None else None
                if gen is not None:
                    g = out["generation"]
                    g["min"] = gen if g["min"] is None else min(g["min"],
                                                                gen)
                    g["max"] = gen if g["max"] is None else max(g["max"],
                                                                gen)
                    if gen < last_gen:
                        g["violations"] += 1
                    last_gen = max(last_gen, gen)
                if status == 200 and isinstance(body, dict):
                    out["ok"] += 1
                    if expect is not None:
                        err = expect(kind, path, body, gen)
                        if err:
                            out["value_errors"].append(err)
                elif (status in TYPED_STATUSES
                      and isinstance(body, dict) and "error" in body):
                    key = str(status)
                    out["typed"][key] = out["typed"].get(key, 0) + 1
                    if status == 429:
                        out["rejected_429"] += 1
                    if body.get("shed"):
                        out["shed"] += 1
                else:
                    out["untyped"].append(
                        {"status": status, "path": path, "body": body})

    stop = threading.Event()
    loris = [threading.Thread(target=_slow_loris,
                              args=(host, port, slow_hold_s, stop),
                              name=f"loadgen-loris-{n}")
             for n in range(slow_clients)]
    pool = [threading.Thread(target=worker, args=(t,),
                             name=f"loadgen-{t}")
            for t in range(threads)]
    t0 = time.monotonic()
    for t in loris + pool:
        t.start()
    for t in pool:
        t.join()
    stop.set()
    for t in loris:
        t.join()
    elapsed = max(time.monotonic() - t0, 1e-9)
    latencies.sort()
    out["elapsed_s"] = round(elapsed, 3)
    out["qps"] = round(out["requests"] / elapsed, 1)
    out["p50_ms"] = round(_percentile(latencies, 0.50), 3)
    out["p99_ms"] = round(_percentile(latencies, 0.99), 3)
    out["by_route"] = {}
    for kind, ms in sorted(by_route.items()):
        ms.sort()
        out["by_route"][kind] = {
            "requests": len(ms), "p50_ms": round(_percentile(ms, 0.50), 3),
            "p99_ms": round(_percentile(ms, 0.99), 3)}
    return out
