"""Qdrant wire-compatible REST façade over the gallery service.

The reference talks to its vector store exclusively through
qdrant-client's REST API (util/qdrant_manager.py:30,
31_clip_embedding_and_save_vector.py:55, 32_create_delegate_vector.py:53,
33_run_all_experiments.py:42). This handler serves the subset of
Qdrant's HTTP API those call sites exercise — collection CRUD, upsert,
retrieve, filtered scroll/count/search, point delete — with Qdrant's
request/response envelopes ({"result": ..., "status": "ok"}), so the
reference's own scripts (or any qdrant-client) can point at
``serve(root, api="qdrant")`` unchanged.

Closed loop: the package's own Qdrant *client* (pipelines/migrate.py,
which speaks the same wire format to real Qdrant servers) migrates
collections out of this façade byte for byte. The port of the JAX
package's ``gallery/qdrant_compat.py``.

Subset notes:
  * filters: ``must`` / ``must_not`` / ``should`` of
    ``{"key", "match": {"value"}}`` conditions — ``must`` is the only
    shape the reference issues (32:104-131, 33:117-137); ``must_not``
    (exclude rows matching ANY negative condition) and ``should``
    (a row must match at least ONE of the group, Qdrant's OR) ride the
    same columnar mask path. ``range`` conditions are rejected with a
    clear error: the fixed 8-field payload contract has no numeric
    fields, so there is nothing for a range to apply to.
  * scroll offsets are opaque integer tokens in ``next_page_offset``
    (clients pass them back verbatim, as with real Qdrant's id tokens).
  * distances map Cosine/Euclid/Dot/Manhattan onto the store's four
    metrics (qdrant_manager.py:61-65).
"""

from __future__ import annotations

import json
import re
from http.server import BaseHTTPRequestHandler

import numpy as np

from retrieval_based_object_detection_tpu_torch.gallery.schema import (
    FIELDS,
    Filter,
    UnknownFieldError,
)

_PAYLOAD_FIELDS = frozenset(FIELDS)

_DIST_IN = {"cosine": "cosine", "euclid": "euclid", "dot": "dot",
            "manhattan": "manhattan"}
_DIST_OUT = {"cosine": "Cosine", "euclid": "Euclid", "dot": "Dot",
             "manhattan": "Manhattan"}

_COLL = re.compile(r"^/collections/([^/?#]+)(/.*)?$")


class _Bad(ValueError):
    """Client error with a Qdrant-style status message."""


def _filter_from_qdrant(body: dict) -> Filter | None:
    flt = body.get("filter")
    if not flt:
        return None
    extra = set(flt) - {"must", "must_not", "should"}
    if extra:
        raise _Bad(f"unsupported filter clauses {sorted(extra)}: this "
                   "facade serves must/must_not/should match conditions "
                   "(the fixed 8-field payload schema has no numeric "
                   "fields, so range conditions are not implemented)")

    def pairs(clause: str) -> list:
        out: list = []
        for cond in flt.get(clause, []):
            if "key" not in cond or "match" not in cond \
                    or "value" not in cond["match"]:
                raise _Bad(f"unsupported filter condition {cond!r}: "
                           'expected {"key": ..., "match": '
                           '{"value": ...}}')
            out.append((cond["key"], cond["match"]["value"]))
        return out

    must: dict = {}
    for key, value in pairs("must"):
        if key in must and must[key] != value:
            # Two positive equality conditions on one field can never
            # both hold; real Qdrant returns an empty result set. The
            # columnar must-map cannot carry both, so refuse loudly
            # instead of last-wins misfiltering.
            raise _Bad(
                f"contradictory must conditions on {key!r} "
                f"({must[key]!r} vs {value!r}) can never match — "
                "did you mean a should group (OR)?")
        must[key] = value
    must_not = tuple(pairs("must_not"))  # pairs: one field may repeat
    should = tuple(pairs("should"))
    return Filter(must=must, must_not=must_not, should=should) \
        if (must or must_not or should) else None


def _filter_req(flt: Filter | None) -> dict:
    """Native-wire body fields for a parsed filter — delegates to THE
    one encoder (schema.Filter.to_wire), shared with the Python client."""
    return flt.to_wire() if flt is not None else {}


def _point_out(p: dict, with_payload: bool, with_vector: bool) -> dict:
    out: dict = {"id": p["id"]}
    out["payload"] = p["payload"] if with_payload else None
    out["vector"] = p.get("vector") if with_vector else None
    return out


def make_qdrant_handler(svc):
    """BaseHTTPRequestHandler subclass speaking Qdrant REST over ``svc``
    (a GalleryService, or a ShardRouter)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        # -------------------------------------------------- plumbing
        def _send(self, result, code=200):
            body = json.dumps({"result": result, "status": "ok",
                               "time": 0.0}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, msg: str, code: int):
            body = json.dumps({"status": {"error": msg},
                               "time": 0.0}).encode()
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
            try:
                return json.loads(raw)
            except Exception as e:
                raise _Bad(f"bad json: {e}")

        def _route(self, method: str) -> None:
            path = self.path.split("?", 1)[0]
            try:
                if path == "/healthz" and method == "GET":
                    # Real Qdrant serves /healthz too; orchestrator
                    # probes must work under api="qdrant", and a
                    # readiness gate needs somewhere to read the warm
                    # progress. Plain-text body like Qdrant's, warming
                    # via header.
                    body = b"healthz check passed"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Rbod-Warming",
                                     "true" if svc.warming else "false")
                    self.end_headers()
                    self.wfile.write(body)
                    return None
                if path == "/collections" and method == "GET":
                    return self._send({"collections": [
                        {"name": c["name"]}
                        for c in svc.list_collections()]})
                m = _COLL.match(path)
                if not m:
                    return self._error(f"no such route: {path}", 404)
                name, sub = m.group(1), m.group(2) or ""
                fn = getattr(self, f"_{method.lower()}{sub.replace('/', '_')}",
                             None)
                if fn is None:
                    return self._error(
                        f"unsupported: {method} {path}", 404)
                return fn(name)
            except _Bad as e:
                return self._error(str(e), 400)
            except (ValueError, UnknownFieldError) as e:
                # Store-level validation (shape/dim mismatches, unknown
                # filter fields — UnknownFieldError IS a ValueError,
                # named here so the 400-vs-404 intent is explicit and
                # it can never fall through to the KeyError clause) is
                # a client error, not a server fault.
                return self._error(str(e), 400)
            except KeyError as e:
                return self._error(f"not found: {e}", 404)
            except Exception as e:
                return self._error(f"{type(e).__name__}: {e}", 500)

        def do_GET(self):
            self._route("GET")

        def do_PUT(self):
            self._route("PUT")

        def do_POST(self):
            self._route("POST")

        def do_DELETE(self):
            self._route("DELETE")

        # -------------------------------------------------- collections
        def _get(self, name):  # GET /collections/{name}
            info = next((c for c in svc.list_collections()
                         if c["name"] == name), None)
            if info is None:
                return self._error(f"collection {name!r} not found", 404)
            # The FULL CollectionInfo field set qdrant-client's pydantic
            # model requires — omitting optimizer_status/segments_count/
            # the config sub-objects fails client-side validation even
            # though the caller only reads points_count.
            self._send({
                "status": "green",
                "optimizer_status": "ok",
                "points_count": info["count"],
                "vectors_count": info["count"],
                "indexed_vectors_count": 0,
                "segments_count": 1,
                "payload_schema": {},
                "config": {
                    "params": {
                        "vectors": {
                            "size": info["dim"],
                            "distance": _DIST_OUT[info["distance"]],
                        },
                        "shard_number": 1,
                        "replication_factor": 1,
                        "write_consistency_factor": 1,
                        "on_disk_payload": False,
                    },
                    "hnsw_config": {"m": 0, "ef_construct": 0,
                                    "full_scan_threshold": 0},
                    "optimizer_config": {
                        "deleted_threshold": 0.0,
                        "vacuum_min_vector_number": 0,
                        "default_segment_number": 1,
                        "flush_interval_sec": 0,
                        "indexing_threshold": 0,
                    },
                    "wal_config": {"wal_capacity_mb": 0,
                                   "wal_segments_ahead": 0},
                    "quantization_config": None,
                },
            })

        def _put(self, name):  # PUT /collections/{name} (create)
            body = self._body()
            vectors = body.get("vectors") or {}
            if "size" not in vectors:
                raise _Bad('missing "vectors": {"size", "distance"}')
            dist = _DIST_IN.get(str(vectors.get("distance",
                                                "Cosine")).lower())
            if dist is None:
                raise _Bad(f"unknown distance {vectors.get('distance')!r}")
            try:
                svc.create(name, {"dim": int(vectors["size"]),
                                  "distance": dist})
            except KeyError:
                return self._error(f"collection {name!r} already exists",
                                   409)
            self._send(True)

        def _delete(self, name):  # DELETE /collections/{name}
            try:
                svc.delete_collection(name)
            except KeyError:
                return self._send(False)  # Qdrant: result false, not 404
            self._send(True)

        # -------------------------------------------------- points
        def _put_points(self, name):  # PUT .../points (upsert)
            body = self._body()
            points = body.get("points")
            if not isinstance(points, list):
                raise _Bad('missing "points" list')
            try:
                ids = [str(p["id"]) for p in points]
                vectors = np.asarray([p["vector"] for p in points],
                                     np.float32)
            except KeyError as e:
                # A malformed POINT is a 400, not the 404 the generic
                # missing-collection KeyError handler would emit.
                raise _Bad(f"point missing required field {e}")
            except (TypeError, ValueError) as e:
                raise _Bad(f"bad vectors: {e}")
            payloads = [p.get("payload") or {} for p in points]
            for pl in payloads:
                extra = set(pl) - _PAYLOAD_FIELDS
                if extra:
                    # Real Qdrant stores arbitrary payload JSON; this
                    # store's columnar schema is the reference's fixed
                    # 8-field contract. Silently dropping the rest
                    # (Payload.from_dict keeps known fields only) would
                    # be undetectable data loss on the write path —
                    # fail loudly like the range-filter rejection.
                    raise _Bad(
                        f"unknown payload field(s) {sorted(extra)}: "
                        "this store serves the fixed 8-field payload "
                        f"schema {sorted(_PAYLOAD_FIELDS)}")
            svc.upsert(name, {"ids": ids, "vectors": vectors,
                              "payloads": payloads})
            self._send({"operation_id": 0, "status": "completed"})

        def _post_points(self, name):  # POST .../points (retrieve)
            body = self._body()
            if "ids" not in body:
                raise _Bad('missing "ids"')
            out = svc.retrieve(name, {
                "ids": body["ids"],
                "with_vectors": bool(body.get("with_vector", False))})
            self._send([
                _point_out({"vector": None, **p},
                           bool(body.get("with_payload", True)),
                           bool(body.get("with_vector", False)))
                for p in out["points"]])

        def _post_points_scroll(self, name):
            body = self._body()
            flt = _filter_from_qdrant(body)
            req = {"limit": int(body.get("limit", 10)),
                   "offset": int(body.get("offset") or 0),
                   "with_vectors": bool(body.get("with_vector", False)),
                   **_filter_req(flt)}
            out = svc.scroll(name, req)
            with_payload = bool(body.get("with_payload", True))
            with_vector = bool(body.get("with_vector", False))
            self._send({
                "points": [_point_out(p, with_payload, with_vector)
                           for p in out["points"]],
                "next_page_offset": out["next_offset"],
            })

        def _post_points_count(self, name):
            body = self._body()
            flt = _filter_from_qdrant(body)
            out = svc.count(name, _filter_req(flt))
            self._send({"count": out["count"]})

        def _post_points_search(self, name):
            body = self._body()
            if "vector" not in body:
                raise _Bad('missing "vector"')
            flt = _filter_from_qdrant(body)
            # Qdrant's default is APPROXIMATE (HNSW); params.exact=true
            # opts into exhaustive search. Mirroring that here keeps
            # capacity/sharded-scale collections servable through the
            # façade (a hardcoded exact=True raised at exactly the
            # scales it exists for); our "approximate" tiers rescore in
            # f32, so hit scores are exact even when the route isn't.
            exact = bool((body.get("params") or {}).get("exact", False))
            out = svc.search(name, {
                "queries": [body["vector"]],
                "k": int(body.get("limit", 10)),
                "exact": exact,
                "with_vectors": bool(body.get("with_vector", False)),
                **_filter_req(flt),
            })
            with_payload = bool(body.get("with_payload", True))
            with_vector = bool(body.get("with_vector", False))
            self._send([
                {**_point_out(h, with_payload, with_vector),
                 "score": h["score"], "version": 0}
                for h in out["results"][0]])

        def _post_points_delete(self, name):
            body = self._body()
            req: dict = {}
            if "points" in body:
                req["ids"] = [str(i) for i in body["points"]]
            flt = _filter_from_qdrant(body)
            req.update(_filter_req(flt))
            if not req:
                raise _Bad('expected "points" ids or "filter"')
            svc.delete_points(name, req)
            self._send({"operation_id": 0, "status": "completed"})

    return Handler
