"""Open-loop HTTP load generator, run as a child process so that the
server's interpreter lock does not move its clock.

    python loadgen.py <spec.json>

The spec names the URL, the request bodies (files), the schedule (each
request's due offset in seconds and its body), the number of sender
threads and the per-request timeout. Each request is sent once: a
refused or dropped connection, an error or a timeout is a failed request
(status 0). The child prints ``ready``, reads the start time
(``time.monotonic()``, shared by every process of the machine) from its
standard input, sends each request when it is due, and writes one
record a request to the spec's ``out`` file: due, sent, done (monotonic
seconds), HTTP status (0 when no answer came) and the answer's body.
A request is timed from when it was due, so a late sender counts
against the latency; ``sent - due`` says how late the generator ran.
Standard library only.
"""

from __future__ import annotations

import http.client
import json
import queue
import sys
import threading
import time
from urllib.parse import urlsplit


def _send(url, body: bytes, timeout: float) -> tuple[int, str]:
    """One request, sent once → (HTTP status, body); status 0 and the
    error when no answer came."""
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=timeout)
    try:
        conn.request("POST", parts.path, body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace")
    except (OSError, http.client.HTTPException) as e:
        return 0, f"{type(e).__name__}: {e}"
    finally:
        conn.close()


def run(spec: dict, start: float) -> list:
    bodies = []
    for path in spec["bodies"]:
        with open(path, "rb") as f:
            bodies.append(f.read())
    schedule = spec["requests"]
    records: list = [None] * len(schedule)
    work: "queue.Queue" = queue.Queue()

    def sender():
        while True:
            item = work.get()
            if item is None:
                return
            i, due, b = item
            sent = time.monotonic()
            status, text = _send(spec["url"], bodies[b], spec["timeout_s"])
            records[i] = [due, sent, time.monotonic(), status, text]

    threads = [threading.Thread(target=sender, daemon=True)
               for _ in range(spec["threads"])]
    for t in threads:
        t.start()
    for i, (offset, b) in enumerate(schedule):
        due = start + offset
        wait = due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        work.put((i, due, b))
    for _ in threads:
        work.put(None)
    for t in threads:
        t.join(timeout=spec["timeout_s"] + 30)
    return records


def main(argv) -> int:
    with open(argv[1]) as f:
        spec = json.load(f)
    print("ready", flush=True)
    start = float(sys.stdin.readline())
    records = run(spec, start)
    with open(spec["out"], "w") as f:
        json.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
