"""Online serving: retrieval-as-detection on the device.

One call per image batch runs the whole chain on the device:

    saliency proposal → margin box → crop+resize → CLIP normalise
    → ViT encode → cosine vs the delegate matrix → argmax class + similarity

The only host work is image decode. ``serve_http`` exposes it as
``POST /detect`` (image bytes) → JSON detections, with ``/reload``,
``/healthz`` and ``/stats``, and micro-batches concurrent requests.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.gallery.schema import Filter
from retrieval_based_object_detection_tpu_torch.gallery.store import Gallery
from retrieval_based_object_detection_tpu_torch.models.clip import (
    model as clip_model,
)
from retrieval_based_object_detection_tpu_torch.models.clip.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
)
from retrieval_based_object_detection_tpu_torch.models.detector import saliency
from retrieval_based_object_detection_tpu_torch.ops.image import (
    crop_resize_batch,
)
from retrieval_based_object_detection_tpu_torch.utils import (
    logging as tracer,
)
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


@torch.inference_mode()
def detect_embed_classify(
    tower: clip_model.CLIPVisionTower,
    images: torch.Tensor,     # [B, H, W, 3] uint8/float 0..255 (fixed size)
    delegates: torch.Tensor,  # [C, D] delegate matrix (rows per class)
    margin_ratio: float = 0.2,
    max_boxes: int = 4,
) -> dict[str, torch.Tensor]:
    """EVERY proposed box classified — outputs are [B, P, ...] (P =
    max_boxes saliency proposals per image, best first). The host side
    gates boxes on confidence (11_dataset_labeling.py:175-180)."""
    with tracer.span("detect.propose"):
        images = images.to(device=tower.device, dtype=torch.float32)
        boxes, conf = saliency.propose_boxes(images, max_boxes=max_boxes)
    out = _margin_embed_classify(tower, images, boxes, delegates,
                                 margin_ratio)
    return {**out, "confidence": conf}


def _margin_embed_classify(tower, images, boxes, delegates, margin_ratio):
    """Margin rule (21:89-95) → crop/resize → CLIP normalise+encode →
    cosine vs delegates → argmax class. ``boxes`` is [B, 4] (outputs
    [B, ...]) or [B, K, 4] (outputs [B, K, ...]); the K crops run as ONE
    [K·B] encode."""
    single = boxes.ndim == 2
    if single:
        boxes = boxes[:, None, :]
    B, K = boxes.shape[:2]
    H, W = images.shape[1], images.shape[2]
    with tracer.span("detect.crop"):
        bw = boxes[..., 2] - boxes[..., 0]
        bh = boxes[..., 3] - boxes[..., 1]
        mx = torch.floor(bw * margin_ratio)
        my = torch.floor(bh * margin_ratio)
        expanded = torch.stack([
            torch.clamp(boxes[..., 0] - mx, 0, W),
            torch.clamp(boxes[..., 1] - my, 0, H),
            torch.clamp(boxes[..., 2] + mx, 0, W),
            torch.clamp(boxes[..., 3] + my, 0, H),
        ], dim=-1)                                   # [B, K, 4]
        crops = torch.cat(
            [crop_resize_batch(images, expanded[:, k],
                               out_size=tower.config.image_size)
             for k in range(K)], dim=0)              # [K*B, S, S, 3]
        crops = torch.clamp(crops / 255.0, 0.0, 1.0)
        mean = torch.as_tensor(CLIP_MEAN, device=crops.device)
        std = torch.as_tensor(CLIP_STD, device=crops.device)
        crops = (crops - mean) / std
    with tracer.span("detect.tower"):
        emb = clip_model.encode_image(tower, crops)
    with tracer.span("detect.classify"):
        emb = emb / torch.clamp(
            torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
        delegates = delegates.to(device=emb.device, dtype=torch.float32)
        dn = delegates / torch.clamp(
            torch.linalg.vector_norm(delegates, dim=-1, keepdim=True),
            min=1e-12)
        sims = (emb @ dn.T).reshape(K, B, -1).permute(1, 0, 2)  # [B, K, C]
        best = sims.max(dim=-1)
    out = {"boxes": expanded, "class_id": best.indices,
           "similarity": best.values, "all_sims": sims}
    if single:
        out = {k: v[:, 0] for k, v in out.items()}
    return out


@torch.inference_mode()
def embed_classify_boxes(
    tower: clip_model.CLIPVisionTower,
    images: torch.Tensor,     # [B, H, W, 3] 0..255
    boxes: torch.Tensor,      # [B, 4] or [B, K, 4] xyxy px (no margin)
    delegates: torch.Tensor,  # [C, D]
    margin_ratio: float = 0.2,
) -> dict[str, torch.Tensor]:
    """Margin→crop→embed→classify for EXTERNAL detector boxes; the
    saliency path lives in detect_embed_classify."""
    images = images.to(device=tower.device, dtype=torch.float32)
    boxes = boxes.to(device=tower.device, dtype=torch.float32)
    return _margin_embed_classify(tower, images, boxes, delegates,
                                  margin_ratio)


@dataclasses.dataclass
class RetrievalDetector:
    """Serving wrapper: gallery delegates + CLIP params → detections.

    ``clip_params`` is a state dict (``params_from_jax``) or a JAX-layout
    numpy pytree; the tower is built on ``device`` in bf16, the serving
    dtype of the JAX package. ``detector=None`` uses the saliency path;
    a detector callable routes its top boxes through the
    margin→embed→classify stage.

    The delegate matrix is a SNAPSHOT, hot-reloaded when the gallery's
    ``write_seq`` moved (``auto_reload``) or on ``reload_delegates()``.
    Swaps are atomic (one tuple); a reload that finds no delegates keeps
    serving the previous snapshot.
    """

    clip_params: dict
    gallery: Gallery
    clip_config: clip_model.CLIPVisionConfig = clip_model.VIT_B_32
    delegate_type: str = "average"
    case: str = "pre_a"
    data_type: str = "original_images"
    detector: object = None
    auto_reload: bool = True
    # Every proposal above the gate becomes a detection; the best box is
    # always returned even below it (11_dataset_labeling.py:159,175-180).
    conf_threshold: float = 0.25
    max_boxes: int = 4
    device: str | torch.device = "cuda"

    def __post_init__(self):
        import threading

        self.device = resolve_device(self.device)
        self.tower = clip_model.build_tower(
            self.clip_params, self.clip_config, dtype=torch.bfloat16,
            device=self.device)
        self._reload_lock = threading.Lock()
        self._snap: tuple[list[str], Any, int] | None = None
        self.reload_delegates(strict=True)

    @property
    def classes(self) -> list[str]:
        return self._snap[0]

    def reload_delegates(self, strict: bool = False) -> int:
        """Rebuild the (classes, delegate-matrix) snapshot from the
        gallery; returns the number of classes. With ``strict=False`` an
        empty or failed rebuild keeps the previous snapshot."""
        flt = (
            Filter(must={"is_delegate": True,
                         "delegate_type": self.delegate_type,
                         "data_type": self.data_type})
            & Filter.for_case(self.case)
        )
        with self._reload_lock:
            seq = getattr(self.gallery, "write_seq", 0)
            try:
                recs = self.gallery.scroll_all(flt, with_vectors=True)
            except Exception:
                if strict or self._snap is None:
                    raise
                # A failed scroll is no observation of the gallery: keep
                # the old seq so the next detect retries the reload.
                return len(self._snap[0])
            if not recs:
                if strict or self._snap is None:
                    raise ValueError(
                        f"no delegates for {self.case}/"
                        f"{self.delegate_type}/{self.data_type} — run "
                        f"the delegates stage first")
                self._snap = (self._snap[0], self._snap[1], seq)
                return len(self._snap[0])
            classes = [r.payload.class_name for r in recs]
            matrix = torch.from_numpy(np.stack([r.vector for r in recs])
                                      ).to(self.device)
            self._snap = (classes, matrix, seq)
            return len(classes)

    def _fresh_snapshot(self) -> tuple[list[str], Any, int]:
        snap = self._snap
        if self.auto_reload:
            seq = getattr(self.gallery, "write_seq", None)
            if seq is not None and seq != snap[2]:
                self.reload_delegates()
                snap = self._snap
        return snap

    def detect(self, images) -> list[dict]:
        """[B, H, W, 3] uint8 (uniform size; numpy or a tensor) →
        per-image detection dicts: the BEST detection's fields at the top
        level plus ``"detections"``, every box whose proposal confidence
        passes ``conf_threshold`` (the best box always included).

        Its stages are the tracer's ``detect.*`` spans; the launches are
        asynchronous, so ``detect.copy_back`` holds the host's wait for
        the card."""
        with tracer.span("detect.snapshot"):
            classes, delegates, _ = self._fresh_snapshot()
        images = torch.as_tensor(images, device=self.device)
        if self.detector is None:
            out = detect_embed_classify(self.tower, images, delegates,
                                        max_boxes=self.max_boxes)
            conf = out["confidence"]                        # [B, P]
        else:
            det_boxes, det_scores = self.detector(images.cpu().numpy())
            kk = min(self.max_boxes, det_scores.shape[1])
            top = np.argsort(-det_scores, axis=1)[:, :kk]   # [B, K]
            top_boxes = np.take_along_axis(
                det_boxes, top[:, :, None].repeat(4, 2), axis=1)
            conf = np.take_along_axis(det_scores, top, axis=1)
            out = embed_classify_boxes(
                self.tower, images,
                torch.as_tensor(top_boxes, dtype=torch.float32), delegates)
        with tracer.span("detect.copy_back"):
            if torch.is_tensor(conf):
                conf = conf.cpu().numpy()
            boxes = out["boxes"].cpu().numpy()              # [B, K, 4]
            cls = out["class_id"].cpu().numpy()
            sim = out["similarity"].cpu().numpy()
        with tracer.span("detect.format"):
            kept = min(boxes.shape[1], self.max_boxes)
            results = []
            for i in range(images.shape[0]):
                dets = [
                    {
                        "box": [float(v) for v in boxes[i, k]],
                        "confidence": float(conf[i, k]),
                        "class_name": classes[int(cls[i, k])],
                        "similarity": float(sim[i, k]),
                    }
                    for k in range(kept)
                    if k == 0 or conf[i, k] >= self.conf_threshold
                ]
                results.append({**dets[0], "detections": dets})
        return results


class MicroBatcher:
    """Dynamic request batching for the serving endpoint.

    Handler threads ``submit()`` a canvas and block; a single worker takes
    the first queued request, waits up to ``max_wait_ms`` for co-arrivals,
    pads the batch up to the next size in ``sizes``, runs ONE
    ``detector.detect`` and distributes per-image results.

    Each answered dispatch counts ``<scope>dispatches.<requests>`` on the
    tracer (its padded size is the first of ``sizes`` that holds it).
    While tracing, each dispatch is a
    ``serve.dispatch`` span (its ``requests`` and ``padded`` size), the
    wait for co-arrivals a ``serve.drain`` span, and each request's time
    from the queue to the dispatch that answers it a ``serve.queue_wait``
    span naming that ``dispatch``.
    """

    def __init__(self, detector, max_batch: int = 16,
                 max_wait_ms: float = 4.0, scope: str = "serve."):
        import queue
        import threading

        self.detector = detector
        self.scope = scope
        self.max_batch = max(1, max_batch)
        self.max_wait_s = max_wait_ms / 1000.0
        # The ladder tops out at max_batch itself so any drained batch
        # finds a rung.
        self.sizes = sorted({s for s in (1, 2, 4, 8, 16, 32, 64)
                             if s < self.max_batch} | {self.max_batch})
        self._q: "queue.Queue[tuple]" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, canvas: np.ndarray) -> dict:
        """Blocking: one [H, W, 3] canvas → its detection dict.

        The canvas moves to the detector's device HERE, in the handler
        thread, so concurrent requests upload in parallel and the worker
        only stacks on the device. A failed move raises to the caller."""
        import threading
        import time as _time

        canvas = torch.as_tensor(canvas, device=self.detector.device)
        done = threading.Event()
        holder: dict = {}
        # The caller's open span (None while tracing is off) and the time
        # the request is queued: the worker records its queue wait.
        cause = tracer.current()
        queued = _time.time_ns() if cause is not None else 0
        self._q.put((canvas, holder, done, cause, queued))
        # Wake periodically to notice a dead worker instead of hanging
        # the HTTP handler thread forever.
        while not done.wait(timeout=1.0):
            if not self._thread.is_alive():
                raise RuntimeError("micro-batch worker died")
        if "error" in holder:
            raise RuntimeError(holder["error"])
        return holder["result"]

    def _drain(self) -> list[tuple]:
        import queue
        import time as _time

        items = [self._q.get()]  # blocks for the first request
        with tracer.span("serve.drain"):
            deadline = _time.monotonic() + self.max_wait_s
            while len(items) < self.max_batch:
                timeout = deadline - _time.monotonic()
                if timeout <= 0 and self._q.empty():
                    break
                try:
                    items.append(self._q.get(timeout=max(timeout, 0)))
                except queue.Empty:
                    break
        return items

    def _worker(self) -> None:
        import time as _time

        while True:
            items = self._drain()
            drained = _time.time_ns()
            n = len(items)
            padded = next(s for s in self.sizes if s >= n)
            # Everything after the drain is inside the try: a stacking
            # error must fail these requests, never kill the worker loop.
            try:
                with tracer.span("serve.dispatch") as span:
                    if span is not None:
                        self._record_waits(span, items, padded, drained)
                    canvases = [c for c, *_ in items]
                    batch = torch.stack(
                        canvases + [canvases[0]] * (padded - n))
                    results = self.detector.detect(batch)[:n]
                    if len(results) != n:
                        raise RuntimeError(
                            f"detector returned {len(results)} results for "
                            f"a {n}-image batch")
                    tracer.count(f"{self.scope}dispatches.{n}")
                    for (_, holder, done, *_), res in zip(items, results):
                        holder["result"] = res
                        done.set()
            except Exception as e:  # fail the waiting requests, not the loop
                for _, holder, done, *_ in items:
                    holder["error"] = f"{type(e).__name__}: {e}"
                    done.set()

    @staticmethod
    def _record_waits(span, items, padded: int, drained: int) -> None:
        span.info["padded"] = padded
        span.info["requests"] = [c.request for *_, c, _ in items
                                 if c is not None]
        for *_, cause, queued in items:
            if cause is not None:
                tracer.record("serve.queue_wait", queued, drained,
                              parent=cause.id, request=cause.request,
                              dispatch=span.id)


# /stats' latency histogram: bucket upper bounds 2**(1/8) apart (9%), from
# 1/16 ms to about 17 minutes, and one bucket past them; one always-on
# counter a bucket, named after the server's scope.
_LATENCY_BOUNDS_MS = [2.0 ** (k / 8) for k in range(-32, 161)]
_LATENCY_BUCKETS = [f"latency_ms.le{b:.4g}"
                    for b in _LATENCY_BOUNDS_MS] + ["latency_ms.over"]
# Numbers each server's counters apart: serve.1., serve.2., ...
_SERVERS = itertools.count(1)


def _count_latency(scope: str, ms: float) -> None:
    import bisect

    tracer.count(scope + _LATENCY_BUCKETS[
        bisect.bisect_left(_LATENCY_BOUNDS_MS, ms)])


def _latency_percentiles(counts: dict[str, int], scope: str
                         ) -> dict | None:
    """p50 and p95 (each its bucket's upper bound, None past the last)
    and n, from the histogram's counters under ``scope``; None before
    the first request."""
    hist = [counts.get(scope + name, 0) for name in _LATENCY_BUCKETS]
    n = sum(hist)
    if not n:
        return None
    out = {}
    for key, q in (("p50", 0.5), ("p95", 0.95)):
        seen, want = 0, q * n
        for bound, c in zip(_LATENCY_BOUNDS_MS + [None], hist):
            seen += c
            if seen >= want:
                out[key] = None if bound is None else round(bound, 2)
                break
    return {**out, "n": n}


def serve_http(detector: RetrievalDetector, host: str = "0.0.0.0",
               port: int = 8080, serving_size: int = 512,
               max_batch: int = 16, batch_wait_ms: float = 4.0):
    """POST /detect with image bytes → JSON detection. Returns the server
    (call serve_forever).

    Uploads are letterboxed to one fixed ``serving_size`` square; returned
    boxes are mapped back to the original image's pixel coordinates.
    Concurrent requests are micro-batched (``MicroBatcher``): up to
    ``max_batch`` co-arriving uploads within ``batch_wait_ms`` run as one
    batch; ``max_batch=1`` disables batching. The listen queue holds
    ``socket.SOMAXCONN`` connections, so a host stall queues arrivals
    instead of refusing them.

    ``GET /healthz`` → liveness (503 once the batching worker died);
    ``GET /stats`` → the operator's read of this server's always-on
    counters on the tracer, ``serve.<n>.*`` (n numbers the process's
    servers from 1): ``requests`` and ``errors``, ``latency_ms`` (p50 and
    p95 from handler entry to the answer ready to write, decode included,
    each the upper bound of its 9% histogram bucket) and the dispatch size
    histogram ``batch_sizes``. ``POST /reload`` → delegate refresh.

    While tracing (``utils.logging.enable``), each ``/detect`` is a
    ``serve.request`` span holding ``serve.read``, ``serve.decode``,
    ``serve.letterbox``, ``serve.wait`` (the detection, queue included)
    and ``serve.respond``, all of one request id.
    """
    import io
    import json
    import socket
    import time as _time
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from retrieval_based_object_detection_tpu_torch.pipelines.labeling import (
        letterbox,
    )

    scope = f"serve.{next(_SERVERS)}."
    batcher = (MicroBatcher(detector, max_batch, batch_wait_ms, scope)
               if max_batch > 1 else None)
    started = _time.time()
    prefix = scope + "dispatches."

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

        def do_GET(self):
            if self.path == "/healthz":
                alive = batcher is None or batcher._thread.is_alive()
                self._json({"ok": alive}, 200 if alive else 503)
            elif self.path == "/stats":
                c = tracer.counters()
                out = {"requests": c.get(scope + "requests", 0),
                       "errors": c.get(scope + "errors", 0),
                       "uptime_s": round(_time.time() - started, 1)}
                lat = _latency_percentiles(c, scope)
                if lat is not None:
                    out["latency_ms"] = lat
                if batcher is not None:
                    sizes = {int(k[len(prefix):]): v for k, v in c.items()
                             if k.startswith(prefix) and v}
                    out["batch_sizes"] = dict(sorted(sizes.items()))
                self._json(out)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path == "/reload":
                try:
                    n = detector.reload_delegates()
                except Exception as e:
                    self._json({"error": f"{type(e).__name__}: {e}"}, 409)
                    return
                self._json({"classes": n})
                return
            if self.path != "/detect":
                self._json({"error": "not found"}, 404)
                return
            t0 = _time.perf_counter()
            with tracer.span("serve.request",
                             request=tracer.new_request()):
                self._detect(t0)

        def _detect(self, t0: float) -> None:
            from PIL import Image

            with tracer.span("serve.read"):
                length = int(self.headers.get("Content-Length") or 0)
                data = self.rfile.read(length)
            try:
                with tracer.span("serve.decode"), \
                        Image.open(io.BytesIO(data)) as im:
                    arr = np.asarray(im.convert("RGB"))
            except Exception:
                self._json({"error": "not an image"}, 400)
                return
            with tracer.span("serve.letterbox"):
                canvas, scale = letterbox(arr, serving_size)
            try:
                with tracer.span("serve.wait"):
                    det = (batcher.submit(canvas) if batcher is not None
                           else detector.detect(canvas[None])[0])
            except Exception as e:
                # Any detect failure answers with a 500, not a dropped
                # connection.
                tracer.count(scope + "requests")
                tracer.count(scope + "errors")
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)
                return

            def _unscale(box):
                return [
                    float(np.clip(
                        v / scale,
                        0, arr.shape[1] if i % 2 == 0 else arr.shape[0]))
                    for i, v in enumerate(box)
                ]

            with tracer.span("serve.respond"):
                det["box"] = _unscale(det["box"])
                for d in det.get("detections", []):
                    d["box"] = _unscale(d["box"])
                # Counted before the answer goes, so a client that has
                # its answer finds it in both counts.
                tracer.count(scope + "requests")
                _count_latency(scope, (_time.perf_counter() - t0) * 1e3)
                self._json(det)

    class Server(ThreadingHTTPServer):
        request_queue_size = socket.SOMAXCONN

    return Server((host, port), Handler)
