"""Gallery HTTP server — the standalone vector-service role Qdrant played.

The reference ran Qdrant as a Docker service on port 6333 and every stage
talked to it over HTTP (02_qdrant_environment_setting.txt:1-8). Most
deployments embed the gallery in-process (no server needed), but for
multi-process setups this module serves the same operation set over a
minimal JSON/HTTP API, with every collection's rows and searches on the
service's device (``serve(..., device="cuda")``):

  GET    /healthz                             {status, warming, filters}
  GET    /collections                         list [name, count]
  PUT    /collections/<name>                  create {dim, distance, force?}
  DELETE /collections/<name>
  POST   /collections/<name>/rename           {new_name}
  GET    /collections/<name>/count            ?filter=<urlencoded json>
  POST   /collections/<name>/count            {filter?}
  POST   /collections/<name>/points           upsert {ids, vectors, payloads}
         (Content-Type: application/octet-stream sends vectors as raw
          f32 bytes after a length-prefixed JSON header — ~20× lighter
          than JSON float lists for bulk ingest; see gallery/client.py)
  POST   /collections/<name>/points/scroll    {filter?, limit?, offset?,
                                               with_vectors?}
  POST   /collections/<name>/points/retrieve  {ids, with_vectors?}
  POST   /collections/<name>/points/search    {queries, k?, filter?, method?,
                                               exact?, with_vectors?}
  POST   /collections/<name>/points/by-path   {img_path, with_vectors?}
  POST   /collections/<name>/points/delete    {ids?, filter?}
  POST   /collections/<name>/maintain         {force?} deferred compaction
  POST   /collections/<name>/warm             pre-build the serving tier
  POST   /snapshot                            persist all collections

Writes hold the collection's write lock; the store snapshots to ``root`` on
/snapshot and on clean shutdown. Filters are the schema's wire maps
(``Filter.to_wire``). The port of the JAX package's ``gallery/server.py``.
"""

from __future__ import annotations

import json
import threading
from contextlib import ExitStack, contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

import torch

from retrieval_based_object_detection_tpu_torch.gallery.schema import (
    Filter,
    UnknownFieldError,
)
from retrieval_based_object_detection_tpu_torch.gallery.store import VectorStore
from retrieval_based_object_detection_tpu_torch.utils.locks import RWLock


def _filter_from(body: dict) -> Filter | None:
    return Filter.from_wire(body)


class GalleryService:
    """Lock-guarded operations over a persistent VectorStore on
    ``device``.

    Locking (real Qdrant serves concurrent reads):

    * ``self.lock`` (RLock) guards TOPOLOGY only: the collection dict
      (create/delete/rename/list) and the per-collection lock registry.
      It is never held while waiting on a collection lock.
    * One ``RWLock`` per collection: searches/scrolls/counts/retrieves
      run CONCURRENTLY under the read side (device dispatch is
      thread-safe; the store's lazy view/mirror builds are serialised
      by ``Gallery._view_mut``), while upsert/delete/maintain/warm —
      and snapshot saves, which may compact — take the write side.
      Collections never block each other.
    * Multi-collection ops (snapshot, rename) acquire write locks in
      sorted-name order so two of them can't deadlock.
    """

    def __init__(self, root: str | Path, mmap_vectors: bool = True,
                 mesh_devices: int = 0,
                 device: str | torch.device = "cuda"):
        from retrieval_based_object_detection_tpu_torch.gallery.persist import (
            load_store,
            save_store,
        )

        self.root = Path(root)
        self._save = save_store
        # mmap by default: the service answers requests immediately after
        # restart whatever the snapshot size; vector pages fault in on
        # first use (persist.load_gallery docstring).
        self.store: VectorStore = load_store(self.root,
                                             mmap_vectors=mmap_vectors,
                                             device=device)
        if mesh_devices:
            # Multi-device serving: shard every cosine collection's rows
            # over a gallery mesh — searches auto-route through the
            # sharded tier behind the same API (store.attach_mesh).
            # mesh_devices=-1 uses every visible device of the store's
            # type (one on the CPU).
            from retrieval_based_object_detection_tpu_torch.parallel.mesh import (
                device_count,
                gallery_mesh,
            )

            dev = self.store.device
            count = device_count(dev)
            n = count if mesh_devices < 0 else min(mesh_devices, count)
            self.store.attach_mesh(gallery_mesh(n, device=dev))
        self.lock = threading.RLock()  # topology + lock registry ONLY
        self._rw: dict[str, RWLock] = {}
        self.warming = False  # True while a background warm runs

    # --------------------------------------------------- lock plumbing
    def _lock_for(self, name: str) -> RWLock:
        """The collection's RWLock (created on demand; survives
        delete+recreate so in-flight waiters stay correct)."""
        with self.lock:
            lk = self._rw.get(name)
            if lk is None:
                lk = self._rw[name] = RWLock()
            return lk

    @contextmanager
    def read_locked(self, name: str):
        """Shared read access to one collection (also the hook the
        Qdrant façade uses for its direct store reads)."""
        with self._lock_for(name).read():
            yield

    @contextmanager
    def write_locked(self, *names: str):
        """Exclusive access to the named collections, acquired in
        sorted order (multi-collection writers can't deadlock)."""
        with ExitStack() as stack:
            for nm in sorted(set(names)):
                stack.enter_context(self._lock_for(nm).write())
            yield

    def _all_names(self) -> list[str]:
        with self.lock:
            return [n for n, _ in self.store.list_collections()]

    def warm_async(self) -> None:
        """Pre-pay first-query costs in a background thread: per
        collection, build the serving tiers + trigger compiles
        (Gallery.warm). The port binds immediately. Lock semantics:
        each collection warms under ITS OWN write lock, so requests to
        the warming collection wait exactly as they would have waited
        on their own cold build, while requests to every other
        collection — warmed or not — proceed concurrently. Smallest
        collections warm first so they come online soonest. A failing
        (or concurrently deleted) collection is logged and skipped,
        never aborting the rest."""
        import sys

        def _run():
            try:
                with self.lock:  # consistent snapshot of the name list
                    names = [n for n, _ in sorted(
                        self.store.list_collections(),
                        key=lambda nc: nc[1])]
                for name in names:
                    try:
                        with self.write_locked(name):
                            s = self.store.get(name).warm()
                        print(f"[gallery] warmed {name!r} in {s:.1f}s",
                              file=sys.stderr)
                    except Exception as e:  # noqa: BLE001 — keep going
                        print(f"[gallery] warm of {name!r} failed: "
                              f"{type(e).__name__}: {e}", file=sys.stderr)
            finally:
                self.warming = False

        self.warming = True
        threading.Thread(target=_run, daemon=True).start()

    def snapshot(self) -> dict:
        # Exclusive over every collection (saves may compact rows),
        # acquired in sorted order. Lock ordering is collection-locks-
        # BEFORE-topology everywhere (holding topology while waiting on
        # a collection lock would deadlock against create/delete, which
        # wait the other way), so topology can shift between listing
        # the names and holding their locks — re-check and retry.
        for _ in range(16):
            names = self._all_names()
            with self.write_locked(*names):
                if set(self._all_names()) != set(names):
                    continue  # collection created/deleted mid-acquire
                with self.lock:
                    self._save(self.store, self.root)
                    return {"saved": [n for n, _ in
                                      self.store.list_collections()]}
        raise RuntimeError(
            "snapshot could not get a stable collection topology "
            "(collections being created/deleted continuously)")

    # ------------------------------------------------------------ ops
    def list_collections(self):
        with self.lock:
            return [{"name": n, "count": c,
                     "dim": self.store.get(n).dim,
                     "distance": self.store.get(n).distance}
                    for n, c in self.store.list_collections()]

    def create(self, name: str, body: dict):
        # Write lock first (collection-locks-BEFORE-topology everywhere):
        # a force-recreate must not swap the gallery out from under an
        # in-flight search on the same name.
        with self.write_locked(name):
            with self.lock:
                if name in self.store and not body.get("force"):
                    raise KeyError(f"collection exists: {name}")
                self.store.create_collection(
                    name, dim=int(body.get("dim", 512)),
                    distance=body.get("distance", "cosine"))
                return {"created": name}

    def delete_collection(self, name: str):
        with self.write_locked(name):
            with self.lock:
                self.store.delete_collection(name)
                return {"deleted": name}

    def rename(self, name: str, body: dict):
        if "new_name" not in body:
            raise ValueError("missing required field(s): ['new_name']")
        with self.write_locked(name, body["new_name"]):
            with self.lock:
                self.store.rename_collection(name, body["new_name"])
                return {"renamed": [name, body["new_name"]]}

    def count(self, name: str, body: dict):
        with self.read_locked(name):
            return {"count": self.store.get(name).count(_filter_from(body))}

    def maintain(self, name: str, body: dict):
        """Deferred-compaction window (Gallery.maintain), server-side —
        the backpressure this drains accrues INSIDE this long-running
        process, so the reclaim (and its durability: base rewrite so the
        delta chain cannot replay the tombstones) must happen here, not
        in a CLI that loaded its own copy of the snapshot."""
        with self.write_locked(name):
            g = self.store.get(name)
            reclaimed = g.maintain(force=bool(body.get("force")))
            if reclaimed:
                g._snap_id = None  # poison: next save rewrites the base
        if reclaimed:
            # The durability save covers EVERY collection, so it takes
            # the all-names write set — after releasing `name`'s lock
            # (re-acquiring a superset while holding one member would
            # violate the sorted acquisition order snapshot relies on).
            self.snapshot()
        return {"reclaimed": reclaimed}

    def warm(self, name: str, body: dict):
        """On-demand Gallery.warm for one collection — after a remote
        bulk ingest, call this before cutting traffic over so the first
        client search doesn't pay the device view build (startup-time
        warming is ``serve(warm=True)``)."""
        with self.write_locked(name):
            return {"seconds": round(self.store.get(name).warm(), 3)}

    def upsert(self, name: str, body: dict):
        missing = [k for k in ("ids", "vectors", "payloads")
                   if k not in body]
        if missing:
            raise ValueError(f"missing required field(s): {missing}")
        with self.write_locked(name):
            g = self.store.get(name)
            n = g.upsert(body["ids"],
                         np.asarray(body["vectors"], np.float32),
                         body["payloads"])
            return {"upserted": n}

    def retrieve(self, name: str, body: dict):
        """Point lookup by ids (the Qdrant façade's retrieve op routes
        here so its store read shares the collection read lock)."""
        if "ids" not in body:
            raise ValueError("missing required field(s): ['ids']")
        with self.read_locked(name):
            recs = self.store.get(name).retrieve(
                [str(i) for i in body["ids"]],
                with_vectors=bool(body.get("with_vectors", False)))
            return {"points": [
                {"id": r.id, "payload": r.payload.to_dict(),
                 **({"vector": r.vector.tolist()}
                    if r.vector is not None else {})}
                for r in recs]}

    def by_path(self, name: str, body: dict):
        """Single-point lookup through Gallery.get_by_path — including
        its resolved-path fallback, which a client-side exact-match
        scroll filter cannot reproduce (the embed and experiment runs
        may spell the same file differently)."""
        if "img_path" not in body:
            raise ValueError("missing required field(s): ['img_path']")
        with self.read_locked(name):
            rec = self.store.get(name).get_by_path(
                str(body["img_path"]),
                with_vectors=bool(body.get("with_vectors", True)))
            if rec is None:
                return {"point": None}
            return {"point": {
                "id": rec.id, "payload": rec.payload.to_dict(),
                **({"vector": rec.vector.tolist()}
                   if rec.vector is not None else {}),
            }}

    def scroll(self, name: str, body: dict):
        with self.read_locked(name):
            recs, next_offset = self.store.get(name).scroll(
                _filter_from(body),
                limit=int(body.get("limit", 10)),
                offset=int(body.get("offset", 0)),
                with_vectors=bool(body.get("with_vectors", False)))
            return {
                "points": [
                    {"id": r.id, "payload": r.payload.to_dict(),
                     **({"vector": r.vector.tolist()}
                        if r.vector is not None else {})}
                    for r in recs
                ],
                "next_offset": next_offset,
            }

    def search(self, name: str, body: dict):
        if "queries" not in body:
            raise ValueError("missing required field(s): ['queries']")
        with self.read_locked(name):
            # Default is auto-routing so the `exact` flag actually works:
            # method=None defers to Gallery.search (exact when
            # exact=True, else bf16/int8 by scale and device); an
            # explicit method overrides.
            method = body.get("method")
            if method == "auto":
                method = None
            with_vectors = bool(body.get("with_vectors", False))
            results = self.store.get(name).search(
                np.asarray(body["queries"], np.float32),
                k=int(body.get("k", 10)),
                flt=_filter_from(body),
                exact=bool(body.get("exact", True)),
                with_vectors=with_vectors,
                method=method)
            return {"results": [
                [{"id": h.id, "score": h.score,
                  "payload": h.payload.to_dict(),
                  **({"vector": h.vector.tolist()}
                     if h.vector is not None else {})} for h in hits]
                for hits in results
            ]}

    def delete_points(self, name: str, body: dict):
        with self.write_locked(name):
            n = self.store.get(name).delete(
                ids=body.get("ids"), flt=_filter_from(body))
            return {"deleted": n}


def make_handler(svc: GalleryService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length") or 0)
            if not length:
                return {}
            raw = self.rfile.read(length)
            if (self.headers.get("Content-Type") or "").startswith(
                    "application/octet-stream"):
                # Binary frame: [u32 header_len][JSON header][f32 bytes].
                # The header carries everything but the vectors plus
                # their shape; the payload is zero-copy row data, a
                # READ-ONLY view of the request bytes: it reaches the
                # device only through copies (the store's host rows and
                # ``store.upload``), never through torch.from_numpy.
                hlen = int.from_bytes(raw[:4], "little")
                body = json.loads(raw[4:4 + hlen])
                key = body.pop("_array_key", "vectors")
                shape = body.pop("_array_shape")
                body[key] = np.frombuffer(
                    raw[4 + hlen:], np.float32).reshape(shape)
                return body
            return json.loads(raw)

        def _route(self, method: str):
            path, _, query = self.path.partition("?")
            parts = [p for p in path.split("/") if p]
            try:
                body = self._body()
            except json.JSONDecodeError:
                return self._json({"error": "bad json"}, 400)
            except (ValueError, KeyError) as e:
                # Malformed binary frame: bad header, missing _array_shape,
                # or a byte count that doesn't match the declared shape.
                return self._json({"error": f"bad binary frame: {e}"}, 400)
            if query and "filter" not in body:
                from urllib.parse import parse_qs

                # parse_qs already percent-decodes values — a second
                # unquote() corrupted filter values containing literal
                # %XX sequences (URL-encoded dataset paths).
                q = parse_qs(query)
                if "filter" in q:
                    try:
                        body["filter"] = json.loads(q["filter"][0])
                    except json.JSONDecodeError:
                        return self._json({"error": "bad filter json"}, 400)
            try:
                if parts == ["healthz"] and method == "GET":
                    # Liveness probe for orchestrators (the detect
                    # endpoint has the same); ``warming`` tells a
                    # readiness gate that --warm is still pre-building
                    # serving tiers (requests are ANSWERED meanwhile —
                    # they queue behind the warming collection's lock).
                    # ``filters`` advertises clause support so clients
                    # can refuse to send must_not/should to an older
                    # server that would silently ignore them
                    # (misfiltering is worse than failing).
                    return self._json({"status": "ok",
                                       "warming": svc.warming,
                                       "filters": ["must", "must_not",
                                                   "should"]})
                if parts == ["collections"] and method == "GET":
                    return self._json(svc.list_collections())
                if parts == ["snapshot"] and method == "POST":
                    return self._json(svc.snapshot())
                if len(parts) == 2 and parts[0] == "collections":
                    name = parts[1]
                    if method == "PUT":
                        return self._json(svc.create(name, body))
                    if method == "DELETE":
                        return self._json(svc.delete_collection(name))
                if len(parts) == 3 and parts[0] == "collections":
                    name, op = parts[1], parts[2]
                    if op == "rename" and method == "POST":
                        return self._json(svc.rename(name, body))
                    if op == "count" and method in ("GET", "POST"):
                        return self._json(svc.count(name, body))
                    if op == "maintain" and method == "POST":
                        return self._json(svc.maintain(name, body))
                    if op == "warm" and method == "POST":
                        return self._json(svc.warm(name, body))
                    if op == "points" and method == "POST":
                        return self._json(svc.upsert(name, body))
                if len(parts) == 4 and parts[0] == "collections" \
                        and parts[2] == "points" and method == "POST":
                    name, op = parts[1], parts[3]
                    if op == "scroll":
                        return self._json(svc.scroll(name, body))
                    if op == "retrieve":
                        return self._json(svc.retrieve(name, body))
                    if op == "search":
                        return self._json(svc.search(name, body))
                    if op == "by-path":
                        return self._json(svc.by_path(name, body))
                    if op == "delete":
                        return self._json(svc.delete_points(name, body))
                return self._json({"error": "not found"}, 404)
            except UnknownFieldError as e:
                # Filter/payload validation: a client error, NOT the
                # missing-collection 404 — clients key recovery paths
                # off 404 (e.g. get_by_path's pre-route fallback).
                return self._json({"error": str(e)}, 400)
            except KeyError as e:
                return self._json({"error": str(e)}, 404 if "exists"
                                  not in str(e) else 409)
            except (ValueError, TypeError) as e:
                return self._json({"error": str(e)}, 400)
            except Exception as e:  # noqa: BLE001 — the HTTP boundary
                # Anything else must still produce an HTTP response: a
                # dropped connection makes the client's binary-frame
                # path misread the failure as pre-binary version skew
                # and re-send the body as 20x-larger JSON.
                return self._json(
                    {"error": f"{type(e).__name__}: {e}"}, 500)

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def do_PUT(self):
            self._route("PUT")

        def do_DELETE(self):
            self._route("DELETE")

    return Handler


def serve(root: str | Path, host: str = "0.0.0.0", port: int = 6333,
          mmap_vectors: bool = True,
          api: str = "native",
          mesh_devices: int = 0,
          warm: bool = False,
          device: str | torch.device = "cuda") -> ThreadingHTTPServer:
    """Start the gallery service (port 6333 mirrors Qdrant's) over the
    snapshots in ``root``, its collections on ``device``. Returns the
    server; the caller runs serve_forever and calls
    ``server.service.snapshot()`` on shutdown.

    ``api="qdrant"`` serves the Qdrant wire-compatible REST façade
    instead of the native API (gallery/qdrant_compat.py) — the
    reference's own qdrant-client call sites work against it unchanged.
    ``mesh_devices`` > 0 (or -1 for all visible devices) serves every
    cosine collection through the sharded tier, clamped to the devices
    there are. ``warm=True`` pre-builds each collection's serving tier in
    a background thread (Gallery.warm): at millions of rows the first
    query otherwise pays the view build.
    """
    svc = GalleryService(root, mmap_vectors=mmap_vectors,
                         mesh_devices=mesh_devices, device=device)
    if warm:
        svc.warm_async()
    if api == "qdrant":
        from retrieval_based_object_detection_tpu_torch.gallery.qdrant_compat import (
            make_qdrant_handler,
        )

        handler = make_qdrant_handler(svc)
    elif api == "native":
        handler = make_handler(svc)
    else:
        raise ValueError(f"unknown api {api!r}: 'native' or 'qdrant'")
    server = ThreadingHTTPServer((host, port), handler)
    server.service = svc
    return server
