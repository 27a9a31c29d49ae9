"""The port's tracer (``utils/logging.py``): spans and counters inside the
serving and search paths, off by default, on ``time.time_ns()``, the
clock of ``torch.profiler``'s events.
"""

import concurrent.futures
import io
import json
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from retrieval_based_object_detection_tpu_torch.gallery.schema import (
    Filter,
    Payload,
)
from retrieval_based_object_detection_tpu_torch.gallery.store import Gallery
from retrieval_based_object_detection_tpu_torch.models.clip import model as tm
from retrieval_based_object_detection_tpu_torch.models.clip.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
)
from retrieval_based_object_detection_tpu_torch.pipelines import delegates
from retrieval_based_object_detection_tpu_torch.pipelines import embed
from retrieval_based_object_detection_tpu_torch.pipelines import serve
from retrieval_based_object_detection_tpu_torch.utils import (
    logging as tracer,
)

CFG = tm.CLIPVisionConfig(image_size=64, patch_size=16, width=64, layers=2,
                          heads=2, embed_dim=32)
COLORS = {"red": (210, 40, 40), "blue": (40, 40, 210), "green": (40, 190, 60)}

SERVE_SPANS = ("serve.read", "serve.decode", "serve.letterbox", "serve.wait",
               "serve.respond")
DETECT_SPANS = ("detect.snapshot", "detect.propose", "detect.crop",
                "detect.tower", "detect.classify", "detect.copy_back",
                "detect.format")


def product_photo(color, rng, size=(160, 200), at=(40, 50)):
    a = np.full(size + (3,), 230, np.uint8)
    y, x = at
    a[y:y + 80, x:x + 100] = color
    return np.clip(a + rng.integers(0, 10, a.shape), 0, 255).astype(np.uint8)


def png(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture
def tracing():
    """The process's tracer on, empty, for one test; off again after."""
    tracer.reset()
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.reset()


@pytest.fixture(scope="module")
def detector():
    params = tm.params_from_jax(tm.init_params(CFG, seed=0))
    rng = np.random.default_rng(0)
    crops, paths, classes = [], [], []
    for cls, col in COLORS.items():
        for i in range(4):
            img = product_photo(col, rng)[24:136, 30:170]
            crops.append(np.asarray(Image.fromarray(img).resize((64, 64))))
            paths.append(f"/{cls}/{i}.png")
            classes.append(cls)
    batch = (np.stack(crops).astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    g = Gallery("tracing", dim=CFG.embed_dim, device="cpu")
    embed.embed_arrays(g, embed.make_encoder(params, CFG, device="cpu"),
                       batch, paths, classes, batch_size=8)
    delegates.build_delegates(g)
    return serve.RetrievalDetector(params, g, CFG, device="cpu")


def small_gallery(n=300, dim=16) -> tuple[Gallery, np.ndarray]:
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(n, dim)).astype(np.float32)
    g = Gallery("rows", dim=dim, device="cpu")
    g.upsert([f"id{i}" for i in range(n)], rows,
             [Payload("original_images", f"c{i % 3}", img_path=f"/{i}.jpg")
              for i in range(n)])
    return g, rows


def serve_uploads(det, uploads, max_batch=8, batch_wait_ms=200):
    """POST every upload at once → (answers, /stats)."""
    srv = serve.serve_http(det, host="127.0.0.1", port=0, serving_size=128,
                           max_batch=max_batch, batch_wait_ms=batch_wait_ms)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(body):
        req = urllib.request.Request(base + "/detect", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        with concurrent.futures.ThreadPoolExecutor(len(uploads)) as ex:
            answers = list(ex.map(post, uploads))
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return answers, stats


def test_tracer_off_records_nothing(detector):
    assert not tracer.TRACER.on
    tracer.reset()
    assert tracer.span("serve.request") is tracer.NO_SPAN
    assert tracer.span("x", request=3, batch=2) is tracer.NO_SPAN
    with tracer.span("x") as rec:
        assert rec is None
    assert tracer.new_request() is None
    tracer.record("x", 0, 1)
    rng = np.random.default_rng(2)
    answers, stats = serve_uploads(
        detector, [png(product_photo(COLORS["red"], rng))])
    assert answers[0]["class_name"] == "red"
    assert stats["requests"] == 1 and stats["errors"] == 0
    g, rows = small_gallery()
    g.search(rows[:2], k=3)
    assert tracer.spans() == []


def test_detect_request_spans_and_counters(detector, tracing):
    rng = np.random.default_rng(3)
    names = ["red", "blue", "green", "red"]
    uploads = [png(product_photo(COLORS[c], rng, size=(150 + 10 * i, 220)))
               for i, c in enumerate(names)]
    before = tracer.counters()
    answers, stats = serve_uploads(detector, uploads)
    after = tracer.counters()
    assert [a["class_name"] for a in answers] == names
    spans = tracer.spans()
    by_id = {s.id: s for s in spans}
    requests = [s for s in spans if s.name == "serve.request"]
    assert len(requests) == len(uploads)
    for req in requests:
        assert req.request is not None and req.parent is None
        mine = [s for s in spans if s.request == req.request]
        for name in SERVE_SPANS:
            (child,) = [s for s in mine if s.name == name]
            assert child.parent == req.id and child.thread == req.thread
            assert req.start_ns <= child.start_ns <= child.end_ns \
                <= req.end_ns
        (wait,) = [s for s in mine if s.name == "serve.wait"]
        (queued,) = [s for s in mine if s.name == "serve.queue_wait"]
        assert queued.parent == wait.id and queued.thread != wait.thread
        dispatch = by_id[queued.info["dispatch"]]
        assert dispatch.name == "serve.dispatch"
        assert req.request in dispatch.info["requests"]
        assert wait.start_ns <= queued.start_ns <= queued.end_ns \
            <= dispatch.start_ns + 1_000_000
    dispatches = [s for s in spans if s.name == "serve.dispatch"]
    assert sum(len(d.info["requests"]) for d in dispatches) == len(uploads)
    assert len([s for s in spans if s.name == "serve.drain"]) \
        == len(dispatches)
    for d in dispatches:
        assert d.request is None and d.info["padded"] >= \
            len(d.info["requests"])
        for name in DETECT_SPANS:
            (child,) = [s for s in spans
                        if s.name == name and s.parent == d.id]
            assert child.thread == d.thread
            assert d.start_ns <= child.start_ns <= child.end_ns <= d.end_ns
    grew = {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}
    # The server counts under its own scope, serve.<n>.
    (scope,) = {k[:-len("requests")] for k in grew if k.endswith(".requests")}
    assert scope.startswith("serve.") and scope + "errors" not in grew
    assert grew[scope + "requests"] == len(uploads)
    sizes = {int(k.rsplit(".", 1)[1]): v for k, v in grew.items()
             if k.startswith(scope + "dispatches.")}
    assert sum(n * c for n, c in sizes.items()) == len(uploads)
    # The padded slots follow from the counts and the batcher's ladder
    # (max_batch 8), as the dispatch spans hold them: slots less padding
    # is the requests.
    slots = sum(c * next(s for s in (1, 2, 4, 8) if s >= n)
                for n, c in sizes.items())
    assert slots == sum(d.info["padded"] for d in dispatches)
    assert slots - sum(d.info["padded"] - len(d.info["requests"])
                       for d in dispatches) == len(uploads)
    assert stats["requests"] == len(uploads) and stats["errors"] == 0
    assert stats["batch_sizes"] == {str(n): c for n, c in sizes.items()}
    assert stats["latency_ms"]["n"] == len(uploads)


def test_stats_latency_counts_from_handler_entry(detector):
    """``/stats`` reads only this server's counters; its latency
    histogram counts each answered request once, timed from the
    handler's entry: no request is faster than its whole
    ``serve.request`` span, decode included."""
    rng = np.random.default_rng(4)
    uploads = [png(product_photo(COLORS["blue"], rng, size=(1200, 1600)))
               for _ in range(3)]
    tracer.reset()
    tracer.enable()
    try:
        _, stats = serve_uploads(detector, uploads, max_batch=1)
        spans = tracer.spans()
    finally:
        tracer.disable()
        tracer.reset()
    request_ms = sorted(s.seconds * 1e3 for s in spans
                        if s.name == "serve.request")
    assert stats["requests"] == 3 and "batch_sizes" not in stats
    assert stats["latency_ms"]["n"] == 3
    assert stats["latency_ms"]["p50"] >= request_ms[1]
    assert stats["latency_ms"]["p95"] >= request_ms[2]


def test_latency_histogram_percentiles():
    counts = {}
    for ms in [1.0] * 50 + [10.0] * 45 + [100.0] * 5:
        i = np.searchsorted(serve._LATENCY_BOUNDS_MS, ms)
        name = "serve.7." + serve._LATENCY_BUCKETS[i]
        counts[name] = counts.get(name, 0) + 1
    got = serve._latency_percentiles(counts, "serve.7.")
    assert got["n"] == 100
    assert 1.0 <= got["p50"] <= 1.0 * 2 ** 0.125 + 0.01
    assert 10.0 <= got["p95"] <= 10.0 * 2 ** 0.125 + 0.01
    assert serve._latency_percentiles(counts, "serve.8.") is None
    assert serve._latency_percentiles({}, "serve.7.") is None


def test_two_servers_in_one_process_keep_their_own_stats(detector):
    """A second server made while the first is still serving counts
    apart: each ``/stats`` holds its own requests, latencies and
    dispatches, and every answered request is in both counts by the
    time its client has the answer."""
    rng = np.random.default_rng(5)
    body = png(product_photo(COLORS["green"], rng))
    servers, threads = [], []
    try:
        for max_batch in (4, 1):
            srv = serve.serve_http(detector, host="127.0.0.1", port=0,
                                   serving_size=128, max_batch=max_batch,
                                   batch_wait_ms=5)
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            servers.append(srv)
            threads.append(th)
        bases = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]

        def post(base):
            req = urllib.request.Request(base + "/detect", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        def stats(base):
            with urllib.request.urlopen(base + "/stats", timeout=30) as r:
                return json.loads(r.read())

        for base in (bases[0], bases[1], bases[0]):
            assert post(base)["class_name"] == "green"
        first, second = stats(bases[0]), stats(bases[1])
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        for th in threads:
            th.join(timeout=30)
    assert (first["requests"], first["latency_ms"]["n"]) == (2, 2)
    assert sum(first["batch_sizes"].values()) == 2
    assert (second["requests"], second["latency_ms"]["n"]) == (1, 1)
    assert "batch_sizes" not in second


@pytest.mark.parametrize("method", ["exact", "bf16", "int8", "int4"])
def test_search_spans_nest_inside_the_call(tracing, method):
    g, rows = small_gallery()
    hits = g.search(rows[:3], k=4, flt=Filter(must={"class_name": "c1"}),
                    method=method)
    assert all(h.payload.class_name == "c1" for q in hits for h in q)
    spans = tracer.spans()
    (call,) = [s for s in spans if s.name == "search.call"]
    parts = [s for s in spans if s.parent == call.id]
    assert [s.name for s in parts] == ["search.prep", "search.copy_back",
                                       "search.records"]
    for a, b in zip(parts, parts[1:]):
        assert a.end_ns <= b.start_ns
    assert call.start_ns <= parts[0].start_ns
    assert parts[-1].end_ns <= call.end_ns
    assert all(s.thread == call.thread for s in parts)


def test_search_capacity_route_is_one_call_span(tracing):
    g, rows = small_gallery()
    g.search(rows[:2], k=3, method="capacity")
    assert [s.name for s in tracer.spans()] == ["search.call"]


def test_span_clock_is_the_profilers(tracing):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("clock") as rec:
            torch.ones(64).add_(1)
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::add_"]
    assert starts
    for t in starts:
        assert rec.start_ns <= t <= rec.end_ns


def test_profile_trace_writes_program_ranges(tmp_path):
    assert not tracer.TRACER.on
    with tracer.profile_trace(tmp_path):
        with tracer.span("unit"):
            torch.ones(8).mul_(2)
    assert not tracer.TRACER.on and not tracer.TRACER.ranges
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert tracer.RANGE_PREFIX + "unit" in names
    tracer.reset()


def test_spans_outside_profile_trace_open_no_ranges(tracing):
    """A traced run of the benchmark counts every device-timeline range
    not its own as a device operation: the tracer opens none there."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("quiet"):
            torch.ones(8).mul_(2)
    assert not any(e.name().startswith(tracer.RANGE_PREFIX)
                   for e in prof.profiler.kineto_results.events())


def test_bounded_span_buffer_counts_what_it_drops():
    t = tracer.Tracer(max_spans=4)
    t.enable()
    for i in range(6):
        with t.span(f"s{i}"):
            pass
    assert [s.name for s in t.spans()] == ["s2", "s3", "s4", "s5"]
    assert t.counters()["tracer.spans_dropped"] == 2
    t.reset()
    assert t.spans() == [] and t.counters()["tracer.spans_dropped"] == 2


def test_nested_spans_and_records_across_threads():
    t = tracer.Tracer()
    t.enable()
    with t.span("outer", request=t.new_request()) as outer:
        with t.span("inner", size=2) as inner:
            cause = t.current()
    assert cause is inner and inner.parent == outer.id
    assert inner.request == outer.request and inner.info == {"size": 2}

    def elsewhere():
        t.record("waited", 5, 9, parent=cause.id, request=cause.request,
                 dispatch=7)

    worker = threading.Thread(target=elsewhere)
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    waited = t.spans()[-1]
    assert (waited.name, waited.start_ns, waited.end_ns) == ("waited", 5, 9)
    assert waited.parent == inner.id and waited.request == outer.request
    assert waited.thread != inner.thread and waited.info == {"dispatch": 7}
    assert t.current() is None


def test_counters_survive_concurrent_counting():
    import sys

    t = tracer.Tracer()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [t.count("n") for _ in range(2000)])
            for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert t.counters() == {"n": 32000}


def test_listen_queue_takes_a_burst_while_the_server_is_held(detector):
    """Sixteen connections opened while the server accepts none (a host
    stall): every one is queued, none refused or left waiting; once the
    server runs, each is answered."""
    srv = serve.serve_http(detector, host="127.0.0.1", port=0,
                           serving_size=128)
    addr = srv.server_address
    socks, thread = [], None
    try:
        for _ in range(16):
            s = socket.create_connection(addr, timeout=0.5)
            socks.append(s)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        for s in socks:
            s.settimeout(30)
            s.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
        for s in socks:
            data = b""
            while chunk := s.recv(4096):
                data += chunk
            assert data.startswith(b"HTTP/1.0 200")
    finally:
        for s in socks:
            s.close()
        if thread is not None:
            srv.shutdown()
        srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()
