"""Multi-host shard router — the scale-out tier behind the one API.

The reference's vector service was a single Qdrant container
(02_qdrant_environment_setting.txt:1-8); its scale-out story would be a
Qdrant cluster behind one endpoint. This module is that tier:
``ShardRouter`` partitions a logical collection across N independent
gallery servers (one per host, each serving its own cards through
``gallery.server.serve``) and speaks the SAME operation surface as
``GalleryService`` — so the native HTTP handler (``server.make_handler``),
the Qdrant wire façade (``qdrant_compat.make_qdrant_handler``) and
``GalleryClient``/``RemoteVectorStore`` work over a multi-host gallery
unchanged. The router itself touches no device. The port of the JAX
package's ``gallery/router.py``.

Topology & semantics:

  * **Write routing is deterministic by point id**: ``md5(id) % n_shards``
    (ids are already content-addressed MD5s, 31_clip:42-43 / 32:29-31,
    so this is uniform and idempotent — re-upserting an id always lands
    on the same shard and overwrites). ``parallel.multihost.
    host_shard_range`` remains the convention for STATIC row-range
    partitioning in ``torch.distributed`` batch jobs; a live store needs
    id-stable routing because rows come and go.
  * **Search fans out** to every shard with the same k/filter/method and
    merges with ``parallel.multihost.merge_host_topk`` — the network leg
    is O(shards × k) per query batch. Each shard picks its own serving tier
    (exact/bf16/int8/int4/capacity by scale), exactly as a single-host
    gallery would.
  * **Scroll** paginates globally in fixed shard order (shard 0's rows
    first), mapping the global offset onto per-shard filtered counts.
  * **Snapshots are per shard**: POST /snapshot broadcasts, each shard
    server persists its own root — a restarted topology reloads shard
    state independently; the router itself is stateless.
  * **Failures are loud**: a fan-out op raises on the FIRST shard error
    (translated to the same KeyError/ValueError taxonomy the HTTP
    handler maps to 404/400) rather than returning partial results — a
    silently missing shard's rows would be undetectable data loss.

Run it: ``serve_router(["http://h1:6333", "http://h2:6333"])`` and
``serve_forever()`` on the returned server.
"""

from __future__ import annotations

import hashlib
import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Sequence

import numpy as np

from retrieval_based_object_detection_tpu_torch.gallery.client import (
    GalleryServiceError,
    _request,
)


def shard_of(point_id: str, n_shards: int) -> int:
    """Deterministic id → shard (stable across runs/processes/restarts:
    pure MD5, no seeded Python hash)."""
    h = hashlib.md5(point_id.encode("utf-8")).digest()
    return int.from_bytes(h[:8], "little") % n_shards


def _translate(e: GalleryServiceError) -> Exception:
    """Shard HTTP error → the exception taxonomy GalleryService raises,
    so the router's own HTTP handler maps it back to the same status."""
    msg = str(e)
    if e.status == 404:
        return KeyError(msg)
    if e.status == 409:
        return KeyError(f"exists: {msg}")
    if e.status == 400:
        return ValueError(msg)
    return RuntimeError(msg)


class ShardRouter:
    """GalleryService-shaped fan-out over N gallery-server base URLs.

    Duck-types the method surface ``server.make_handler`` and
    ``qdrant_compat.make_qdrant_handler`` call, so both wire APIs serve
    a sharded gallery with zero handler changes.
    """

    def __init__(self, shards: Sequence[str], probe_timeout: float = 5.0):
        if not shards:
            raise ValueError("ShardRouter needs at least one shard URL")
        self.shards = [s.rstrip("/") for s in shards]
        self.probe_timeout = probe_timeout
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, len(self.shards)),
            thread_name_prefix="shard-router")

    # ------------------------------------------------------- plumbing
    def _one(self, shard: int, method: str, path: str,
             body: dict | None = None, array_key: str | None = None,
             array: np.ndarray | None = None) -> Any:
        try:
            return _request(method, f"{self.shards[shard]}{path}", body,
                            array_key=array_key, array=array)
        except GalleryServiceError as e:
            raise _translate(e) from e
        except OSError as e:
            raise RuntimeError(
                f"shard {shard} ({self.shards[shard]}) unreachable: "
                f"{e}") from e

    def _fanout(self, fn: Callable[[int], Any]) -> list[Any]:
        """Run fn(shard_idx) on every shard concurrently; first error
        wins (the rest still complete — no cancellation races)."""
        futures = [self._pool.submit(fn, i) for i in range(len(self.shards))]
        results, first_err = [None] * len(futures), None
        for i, f in enumerate(futures):
            try:
                results[i] = f.result()
            except Exception as e:  # noqa: BLE001 — re-raised below
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return results

    # ------------------------------------------------------- healthz
    @property
    def warming(self) -> bool:
        """True while ANY shard reports warming. Raises if a shard's
        /healthz is unreachable — the router's own /healthz then 500s,
        which is the honest liveness answer for a topology that cannot
        serve a complete result."""
        def probe(i: int) -> bool:
            req = urllib.request.Request(f"{self.shards[i]}/healthz")
            try:
                with urllib.request.urlopen(
                        req, timeout=self.probe_timeout) as r:
                    return bool(json.loads(r.read()).get("warming"))
            except OSError as e:
                raise RuntimeError(
                    f"shard {i} ({self.shards[i]}) healthz unreachable: "
                    f"{e}") from e

        return any(self._fanout(probe))

    # ------------------------------------------------------ topology
    def list_collections(self) -> list[dict]:
        per = self._fanout(
            lambda i: self._one(i, "GET", "/collections"))
        # Union of names (a partially created collection still shows);
        # counts sum across shards; dim/distance from the first shard
        # that has the collection.
        order: list[str] = []
        agg: dict[str, dict] = {}
        for cols in per:
            for c in cols:
                if c["name"] not in agg:
                    order.append(c["name"])
                    agg[c["name"]] = dict(c)
                else:
                    agg[c["name"]]["count"] += c["count"]
        return [agg[n] for n in order]

    def create(self, name: str, body: dict):
        self._fanout(lambda i: self._one(
            i, "PUT", f"/collections/{name}", body))
        return {"created": name}

    def delete_collection(self, name: str):
        self._fanout(lambda i: self._one(
            i, "DELETE", f"/collections/{name}"))
        return {"deleted": name}

    def rename(self, name: str, body: dict):
        if "new_name" not in body:
            raise ValueError("missing required field(s): ['new_name']")
        self._fanout(lambda i: self._one(
            i, "POST", f"/collections/{name}/rename", body))
        return {"renamed": [name, body["new_name"]]}

    def snapshot(self) -> dict:
        per = self._fanout(lambda i: self._one(i, "POST", "/snapshot"))
        saved: list[str] = []
        for out in per:
            for n in out["saved"]:
                if n not in saved:
                    saved.append(n)
        return {"saved": saved}

    # ----------------------------------------------------- maintenance
    def maintain(self, name: str, body: dict):
        per = self._fanout(lambda i: self._one(
            i, "POST", f"/collections/{name}/maintain", body))
        return {"reclaimed": sum(out["reclaimed"] for out in per)}

    def warm(self, name: str, body: dict):
        per = self._fanout(lambda i: self._one(
            i, "POST", f"/collections/{name}/warm", body))
        # Shards warm concurrently: wall time is the slowest shard.
        return {"seconds": max(out["seconds"] for out in per)}

    # ----------------------------------------------------------- writes
    def upsert(self, name: str, body: dict):
        missing = [k for k in ("ids", "vectors", "payloads")
                   if k not in body]
        if missing:
            raise ValueError(f"missing required field(s): {missing}")
        ids = list(body["ids"])
        vectors = np.asarray(body["vectors"], np.float32)
        payloads = list(body["payloads"])
        if not (len(ids) == vectors.shape[0] == len(payloads)):
            raise ValueError(
                f"ids/vectors/payloads length mismatch: {len(ids)}/"
                f"{vectors.shape[0]}/{len(payloads)}")
        groups: dict[int, list[int]] = {}
        for j, pid in enumerate(ids):
            groups.setdefault(shard_of(str(pid), len(self.shards)),
                              []).append(j)

        def send(i: int) -> int:
            rows = groups.get(i)
            if not rows:
                return 0
            return int(self._one(
                i, "POST", f"/collections/{name}/points",
                {"ids": [ids[j] for j in rows],
                 "payloads": [payloads[j] for j in rows]},
                array_key="vectors", array=vectors[rows])["upserted"])

        return {"upserted": sum(self._fanout(send))}

    def delete_points(self, name: str, body: dict):
        ids = body.get("ids")
        if ids:
            groups: dict[int, list[str]] = {}
            for pid in ids:
                groups.setdefault(shard_of(str(pid), len(self.shards)),
                                  []).append(pid)

            def send(i: int) -> int:
                if i not in groups:
                    return 0
                b = {k: v for k, v in body.items() if k != "ids"}
                b["ids"] = groups[i]
                return int(self._one(
                    i, "POST", f"/collections/{name}/points/delete",
                    b)["deleted"])

            return {"deleted": sum(self._fanout(send))}
        # Filter-only delete: broadcast (matching rows live anywhere).
        per = self._fanout(lambda i: self._one(
            i, "POST", f"/collections/{name}/points/delete", body))
        return {"deleted": sum(out["deleted"] for out in per)}

    # ------------------------------------------------------------ reads
    def count(self, name: str, body: dict):
        per = self._fanout(lambda i: self._one(
            i, "POST", f"/collections/{name}/count", body))
        return {"count": sum(out["count"] for out in per)}

    def retrieve(self, name: str, body: dict):
        if "ids" not in body:
            raise ValueError("missing required field(s): ['ids']")
        ids = [str(i) for i in body["ids"]]
        groups: dict[int, list[str]] = {}
        for pid in ids:
            groups.setdefault(shard_of(pid, len(self.shards)),
                              []).append(pid)

        def fetch(i: int) -> list[dict]:
            if i not in groups:
                return []
            b = dict(body)
            b["ids"] = groups[i]
            return self._one(i, "POST",
                             f"/collections/{name}/points/retrieve",
                             b)["points"]

        found: dict[str, dict] = {}
        for pts in self._fanout(fetch):
            for p in pts:
                found.setdefault(p["id"], p)
        # Input order, duplicates preserved, misses skipped — the
        # single-host Gallery.retrieve contract.
        return {"points": [found[pid] for pid in ids if pid in found]}

    def by_path(self, name: str, body: dict):
        if "img_path" not in body:
            raise ValueError("missing required field(s): ['img_path']")
        per = self._fanout(lambda i: self._one(
            i, "POST", f"/collections/{name}/points/by-path", body))
        for out in per:  # deterministic: lowest shard index wins
            if out.get("point") is not None:
                return out
        return {"point": None}

    def scroll(self, name: str, body: dict):
        limit = int(body.get("limit", 10))
        if limit <= 0:
            raise ValueError("scroll limit must be positive")
        offset = int(body.get("offset", 0))
        flt_body = {k: v for k, v in body.items()
                    if k in ("filter", "filter_not", "filter_should")}
        counts = self._fanout(lambda i: int(self._one(
            i, "POST", f"/collections/{name}/count", flt_body)["count"]))
        total = sum(counts)
        points: list[dict] = []
        pos = offset
        cum = 0
        for i, c in enumerate(counts):
            if len(points) >= limit:
                break
            if pos < cum + c:
                local = pos - cum
                b = dict(body)
                b["offset"] = local
                b["limit"] = limit - len(points)
                out = self._one(i, "POST",
                                f"/collections/{name}/points/scroll", b)
                points.extend(out["points"])
                pos += len(out["points"])
            cum += c
        nxt = pos if pos < total and points else None
        return {"points": points, "next_offset": nxt}

    def search(self, name: str, body: dict):
        if "queries" not in body:
            raise ValueError("missing required field(s): ['queries']")
        from retrieval_based_object_detection_tpu_torch.parallel.multihost import (
            merge_host_topk,
        )

        queries = np.asarray(body["queries"], np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        k = int(body.get("k", 10))
        rest = {kk: v for kk, v in body.items() if kk != "queries"}

        per = self._fanout(lambda i: self._one(
            i, "POST", f"/collections/{name}/points/search", rest,
            array_key="queries", array=queries)["results"])

        # The host-side merge: per-shard [Q, k] score planes, indices
        # encode (shard, rank) so the winners map back to full hit dicts
        # (payload/vector included) without re-fetching.
        Q = queries.shape[0]
        scores, index = [], []
        for si, results in enumerate(per):
            s = np.full((Q, k), -np.inf, np.float32)
            ix = np.zeros((Q, k), np.int64)
            for qi, hits in enumerate(results):
                for r, h in enumerate(hits):
                    s[qi, r] = h["score"]
                    ix[qi, r] = si * k + r
            scores.append(s)
            index.append(ix)
        ms, mi = merge_host_topk(scores, index, k=k)
        merged = []
        for qi in range(Q):
            row = []
            for s, enc in zip(ms[qi], mi[qi]):
                if not np.isfinite(s):
                    continue  # fewer than k matches globally
                si, r = int(enc) // k, int(enc) % k
                row.append(per[si][qi][r])
            merged.append(row)
        return {"results": merged}


def serve_router(shards: Sequence[str], host: str = "0.0.0.0",
                 port: int = 6334, api: str = "native"):
    """Start the shard-router service. Same wire APIs as ``serve``
    (native or the Qdrant façade), fronting N gallery-server shards —
    ``GalleryClient(base_url=router)`` and ``RemoteVectorStore(router)``
    work unchanged over the multi-host gallery."""
    from http.server import ThreadingHTTPServer

    from retrieval_based_object_detection_tpu_torch.gallery.server import (
        make_handler,
    )

    svc = ShardRouter(shards)
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
