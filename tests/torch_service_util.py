"""Helpers of the port's service parity tests (not a test module).

A JAX server and a port server (``device="cpu"``) are started on ephemeral
ports over copies of one snapshot root; the same raw HTTP requests go to
both, and the JSON bodies are compared with float leaves within 1e-6.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np

from retrieval_based_object_detection_tpu.gallery import persist as jpersist
from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery.store import (
    VectorStore as JStore,
)

SCORE_TOL = 1e-6


def payload(i: int, name: str = "prod") -> dict:
    return {"data_type": "natural_images" if i % 5 == 0
            else "original_images",
            "class_name": ("cola", "fanta", "sprite")[i % 3],
            "img_path": f"/data/{name}/{i}.png",
            "is_cropped": True, "is_segmented": bool(i % 2),
            "is_augmented": i % 7 == 0}


def build_root(root, seed: int = 0, n: int = 40, dim: int = 8,
               names=("prod",)) -> np.ndarray:
    """A snapshot root written by the JAX package: ``names`` cosine
    collections of ``n`` seeded rows each. Returns the first one's
    vectors."""
    rng = np.random.default_rng(seed)
    store = JStore()
    first = None
    for name in names:
        g = store.create_collection(name, dim=dim)
        vecs = rng.normal(size=(n, dim)).astype(np.float32)
        g.upsert([f"{name}-{i}" for i in range(n)], vecs,
                 [jschema.Payload.from_dict(payload(i, name))
                  for i in range(n)])
        first = vecs if first is None else first
    jpersist.save_store(store, root)
    return first


def copy_root(src, dst) -> None:
    shutil.copytree(src, dst)


@contextlib.contextmanager
def running(server):
    """Serve ``server`` on a thread; yields its base URL; stops it."""
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def call(method: str, url: str, body=None, raw: bytes | None = None,
         ctype: str | None = None):
    """(status, parsed JSON body or text) of one request."""
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method)
    if ctype:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, text = r.status, r.read()
            headers = dict(r.headers)
    except urllib.error.HTTPError as e:
        status, text, headers = e.code, e.read(), dict(e.headers)
    try:
        return status, json.loads(text), headers
    except json.JSONDecodeError:
        return status, text.decode(), headers


def binary_frame(header: dict, array: np.ndarray, key: str) -> bytes:
    """The service's octet-stream frame: [u32 len][JSON header][f32]."""
    h = dict(header, _array_key=key, _array_shape=list(array.shape))
    hj = json.dumps(h).encode()
    return (len(hj).to_bytes(4, "little") + hj
            + np.ascontiguousarray(array, np.float32).tobytes())


def assert_same(a, b, path: str = "$") -> None:
    """Equal JSON values; floats within SCORE_TOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        assert abs(a - b) <= SCORE_TOL, (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def replay(steps, bases) -> list:
    """Send each step ``(method, path, body | ("binary", header, array,
    key))`` to every base URL; assert equal status and body; return the
    JSON bodies of the first base."""
    out = []
    for method, path, body in steps:
        got = []
        for base in bases:
            if isinstance(body, tuple) and body[0] == "binary":
                _, header, arr, key = body
                got.append(call(method, base + path,
                                raw=binary_frame(header, arr, key),
                                ctype="application/octet-stream"))
            elif isinstance(body, tuple) and body[0] == "raw":
                got.append(call(method, base + path, raw=body[1],
                                ctype="application/json"))
            else:
                got.append(call(method, base + path, body))
        (s0, b0, _), *rest = got
        for s, b, _ in rest:
            assert s == s0, (method, path, s0, s, b0, b)
            assert_same(b0, b, f"{method} {path}")
        out.append((s0, b0))
    return out
