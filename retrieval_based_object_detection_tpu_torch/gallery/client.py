"""HTTP client for the gallery service — the stage side of the
multi-process topology.

The reference ran every stage against a Qdrant container over HTTP
(02_qdrant_environment_setting.txt:1-8). The gallery is embedded
in-process by default, but for the served topology (``gallery.server.
serve`` or ``gallery.router.serve_router``) this client mirrors the
``Gallery``/``VectorStore`` surface the pipelines use, so a stage runs
unmodified against a remote gallery: ``RemoteVectorStore(url)`` stands in
for a loaded ``VectorStore``. It speaks the wire format of the JAX
package's service too. The port of the JAX package's ``gallery/client.py``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Sequence

import numpy as np

from retrieval_based_object_detection_tpu_torch.gallery.schema import (
    Filter,
    Payload,
)
from retrieval_based_object_detection_tpu_torch.gallery.store import Record


class GalleryServiceError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"gallery service HTTP {status}: {message}")
        self.status = status


def _request(method: str, url: str, body: dict | None = None,
             array_key: str | None = None,
             array: np.ndarray | None = None) -> Any:
    """JSON request, or — when ``array`` is given — the binary frame
    [u32 header_len][JSON header][raw f32 bytes]: bulk vectors ship as
    bytes instead of JSON float lists (~20× smaller, no float parsing).

    A server predating the binary transport chokes on the frame before
    acting on it — HTTP 400 when the bytes happen to decode as UTF-8,
    a dropped connection otherwise (its ``json.loads`` raises
    UnicodeDecodeError inside the handler). In either case the request
    is retried once as plain JSON with the array as a float list, so an
    upgraded client keeps working against a long-running older server."""
    if array is not None:
        header = dict(body or {})
        header["_array_key"] = array_key
        header["_array_shape"] = list(array.shape)
        hjson = json.dumps(header).encode()
        data = (len(hjson).to_bytes(4, "little") + hjson
                + np.ascontiguousarray(array, np.float32).tobytes())
        ctype = "application/octet-stream"
    else:
        data = json.dumps(body).encode() if body is not None else None
        ctype = "application/json"
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", ctype)
    def _json_retry():
        json_body = dict(body or {})
        json_body[array_key or "vectors"] = array.tolist()
        return _request(method, url, json_body)

    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            msg = json.loads(e.read()).get("error", "")
        except Exception:
            msg = ""
        if array is not None and e.code == 400 and msg == "bad json":
            # Version skew: a JSON-only server fed the binary frame fails
            # json.loads on the raw bytes -> exactly "bad json". Any
            # other 400 (e.g. a validation error from a binary-capable
            # server) must surface immediately — resending a multi-GB
            # upsert as a 20x JSON body just to receive the same 400 is
            # not a retry strategy.
            return _json_retry()
        raise GalleryServiceError(e.code, msg) from e
    except (urllib.error.URLError, ConnectionError) as e:
        # A pre-binary server dies mid-request on the frame (handler
        # UnicodeDecodeError) → the connection is RESET without the
        # request having been acted on — safe to retry as JSON. Only
        # that class of failure retries: a timeout or DNS error on a
        # live binary-capable server must surface, not silently resend
        # a possibly-applied bulk write as a 20× JSON body.
        reason = getattr(e, "reason", e)
        reset = (isinstance(e, ConnectionError)
                 or isinstance(reason, ConnectionError))
        if array is not None and reset:
            return _json_retry()
        raise


def _filter_body(flt: Filter | None) -> dict:
    return flt.to_wire() if flt is not None else {}


class GalleryClient:
    """One remote collection, with the Gallery methods the stages use."""

    def __init__(self, base_url: str, name: str, dim: int | None = None,
                 distance: str = "cosine"):
        self.base = base_url.rstrip("/")
        self.name = name
        self._dim = dim
        self.distance = distance
        self._neg_filters_ok: bool | None = None  # probed on first use

    def _checked_filter_body(self, flt: Filter | None) -> dict:
        """Wire-encode a filter; REFUSE to send must_not/should clauses
        to a server that does not advertise support (GET /healthz
        ``filters``): an older server reads only body['filter'] and
        would silently ignore the negative/OR clauses — a filtered
        delete would then remove rows the must_not was protecting.
        Failing loudly beats misfiltering (same stance as the façade's
        unsupported-clause 400s)."""
        body = _filter_body(flt)
        if "filter_not" in body or "filter_should" in body:
            if self._neg_filters_ok is None:
                try:
                    out = _request("GET", f"{self.base}/healthz")
                except GalleryServiceError:
                    # The server ANSWERED but has no /healthz (pre-probe
                    # version): definitively incapable — cache False.
                    self._neg_filters_ok = False
                except Exception:
                    # Transport blip (timeout, connection reset): the
                    # server's capability is UNKNOWN, not absent. Refuse
                    # this call but leave the probe un-cached so the next
                    # call re-probes — a long-lived client must not
                    # reject must_not/should forever because one healthz
                    # round-trip failed.
                    raise GalleryServiceError(
                        503,
                        "could not probe filter-clause support (GET "
                        "/healthz unreachable); retry when the gallery "
                        "server is reachable")
                else:
                    self._neg_filters_ok = "must_not" in (
                        out.get("filters") or ())
            if not self._neg_filters_ok:
                raise GalleryServiceError(
                    400,
                    "server does not advertise must_not/should filter "
                    "support (GET /healthz) — an older gallery-server "
                    "silently ignores those clauses; upgrade it or use "
                    "must-only filters")
        return body

    # ------------------------------------------------------------ meta
    @property
    def dim(self) -> int:
        if self._dim is None:
            for c in _request("GET", f"{self.base}/collections"):
                if c["name"] == self.name:
                    self._dim = int(c.get("dim", 512))
                    break
            else:
                raise KeyError(f"no such collection: {self.name}")
        return self._dim

    def _url(self, op: str = "") -> str:
        return f"{self.base}/collections/{self.name}{op}"

    def __len__(self) -> int:
        return self.count()

    def count(self, flt: Filter | None = None) -> int:
        return int(_request("POST", self._url("/count"),
                            self._checked_filter_body(flt))["count"])

    # ------------------------------------------------------------ writes
    def upsert(self, ids: Sequence[str], vectors, payloads) -> int:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        pls = [p.to_dict() if isinstance(p, Payload) else p
               for p in payloads]
        return int(_request(
            "POST", self._url("/points"),
            {"ids": list(ids), "payloads": pls},
            array_key="vectors", array=vectors)["upserted"])

    def delete(self, ids: Sequence[str] | None = None,
               flt: Filter | None = None) -> int:
        body = self._checked_filter_body(flt)
        if ids is not None:
            body["ids"] = list(ids)
        return int(_request("POST", self._url("/points/delete"),
                            body)["deleted"])

    # ------------------------------------------------------------ reads
    @staticmethod
    def _record(p: dict) -> Record:
        return Record(
            id=p["id"],
            payload=Payload.from_dict(p["payload"]),
            vector=(np.asarray(p["vector"], np.float32)
                    if "vector" in p else None),
            score=p.get("score"),
        )

    def scroll(self, flt: Filter | None = None, limit: int = 10,
               offset: int = 0, with_vectors: bool = False
               ) -> tuple[list[Record], int | None]:
        body = self._checked_filter_body(flt)
        body.update(limit=limit, offset=offset, with_vectors=with_vectors)
        out = _request("POST", self._url("/points/scroll"), body)
        return ([self._record(p) for p in out["points"]],
                out["next_offset"])

    def scroll_all(self, flt: Filter | None = None,
                   with_vectors: bool = False) -> list[Record]:
        records: list[Record] = []
        offset: int | None = 0
        while offset is not None:
            page, offset = self.scroll(flt, limit=4096, offset=offset,
                                       with_vectors=with_vectors)
            records.extend(page)
        return records

    def retrieve(self, ids: Sequence[str], with_vectors: bool = True
                 ) -> list[Record]:
        out = _request("POST", self._url("/points/retrieve"),
                       {"ids": list(ids), "with_vectors": with_vectors})
        return [self._record(p) for p in out["points"]]

    def get_by_path(self, img_path: str, with_vectors: bool = True
                    ) -> Record | None:
        # The dedicated route goes through Gallery.get_by_path
        # server-side, which includes the resolved-path fallback an
        # exact-match scroll filter cannot reproduce (abs/rel path
        # spelling differences between the embed and experiment runs).
        try:
            out = _request(
                "POST", self._url("/points/by-path"),
                {"img_path": img_path, "with_vectors": with_vectors})
            p = out.get("point")
            if p is None:
                return None
            return self._record(p)
        except GalleryServiceError as e:
            if e.status != 404:
                raise
            # Pre-route server: exact-match scroll (no fallback).
            recs, _ = self.scroll(Filter(must={"img_path": img_path}),
                                  limit=1, with_vectors=with_vectors)
            return recs[0] if recs else None

    def vectors_matching(self, flt: Filter | None = None) -> np.ndarray:
        recs = self.scroll_all(flt, with_vectors=True)
        if not recs:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([r.vector for r in recs])

    def distinct(self, fieldname: str, flt: Filter | None = None) -> list:
        recs = self.scroll_all(flt)
        return sorted({getattr(r.payload, fieldname) for r in recs
                       if getattr(r.payload, fieldname) is not None})

    def maintain(self, force: bool = False) -> int:
        """Server-side deferred compaction (Gallery.maintain); the
        server owns the reclaim AND its durability (base rewrite)."""
        return int(_request("POST", self._url("/maintain"),
                            {"force": bool(force)})["reclaimed"])

    def warm(self) -> float:
        """Server-side Gallery.warm: pre-build the serving tier after a
        bulk ingest, before cutting traffic over. Returns seconds the
        server spent."""
        return float(_request("POST", self._url("/warm"), {})["seconds"])

    def search(self, queries, k: int = 10, flt: Filter | None = None,
               exact: bool = True, with_vectors: bool = False,
               method: str | None = None) -> list[list[Record]]:
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        body = self._checked_filter_body(flt)
        # method=None -> "auto": the SERVER's Gallery.search picks the
        # tier (exact / bf16 / int8-at-scale), same as a local gallery.
        body.update(k=k, method=method or "auto", exact=exact,
                    with_vectors=with_vectors)
        out = _request("POST", self._url("/points/search"), body,
                       array_key="queries", array=queries)
        return [[self._record(h) for h in hits] for hits in out["results"]]


class RemoteVectorStore:
    """VectorStore façade over the HTTP service (or the shard router):
    ``get`` and ``create_collection`` return ``GalleryClient``s."""

    def __init__(self, base_url: str):
        self.base = base_url.rstrip("/")

    def list_collections(self) -> list[tuple[str, int]]:
        return [(c["name"], c["count"])
                for c in _request("GET", f"{self.base}/collections")]

    def __contains__(self, name: str) -> bool:
        return any(n == name for n, _ in self.list_collections())

    def get(self, name: str) -> GalleryClient:
        if name not in self:
            raise KeyError(name)
        return GalleryClient(self.base, name)

    def create_collection(self, name: str, dim: int = 512,
                          distance: str = "cosine",
                          recreate: bool = True) -> GalleryClient:
        _request("PUT", f"{self.base}/collections/{name}",
                 {"dim": dim, "distance": distance, "force": recreate})
        return GalleryClient(self.base, name, dim=dim, distance=distance)

    def rename_collection(self, old: str, new: str) -> None:
        _request("POST", f"{self.base}/collections/{old}/rename",
                 {"new_name": new})

    def delete_collection(self, name: str) -> None:
        _request("DELETE", f"{self.base}/collections/{name}")

    def delete_all_collections(self) -> int:
        names = [n for n, _ in self.list_collections()]
        for n in names:
            self.delete_collection(n)
        return len(names)

    def snapshot(self) -> list[str]:
        return _request("POST", f"{self.base}/snapshot")["saved"]
