"""Traffic kind ``detect_http``: users upload product photos to the
detection service, ``POST /detect``, at a fixed open-loop rate.

Set-up: seeded CLIP weights on the card; a gallery of seeded crops (
``gallery_classes`` × ``crops_per_class``) embedded by the port and its
delegates built; ``serve_http(RetrievalDetector(...))`` on 127.0.0.1 at an
ephemeral port; a pool of seeded JPEG uploads, ``photos_per_size`` of each
size; every dispatch size of the micro-batcher and the HTTP path warmed,
then ``warm_seconds`` of load at the cell's rate.

Window: a child process sends ``round(rate_per_s × seconds)`` requests,
open loop, the gaps between arrivals a Poisson process's (the same
exponential quantiles for every seed, in a seeded order), each upload
from the pool in a seeded order that uses every pool entry equally.
Every request is timed from when it was due to the end of its response;
a failed one counts as ``FAILED_MS``.

End to end: ``detect_slo_share``, the share of every request of the
window answered within ``slo_ms`` of when it was due. Per layer: the
window's latencies (``detect_latency_p95_ms``) and the spans of the
harness's detector wrapper: dispatches, their host-clock seconds and
padded sizes.

Check: a seeded sample of the requests is answered again by
``reference.detect`` from the same upload bytes and gallery crops: the
boxes, their confidences, and for each served box the reference's cosine
of the served class against its best class and against the served
similarity.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from benchcore import images as imgs
from benchcore import stats
from benchcore.context import MISSING, Outcome
from benchcore.device import device_block
from benchcore.port import clip_config
from benchcore.weights import clip_state

LOADGEN = Path(__file__).resolve().parents[1] / "benchcore" / "loadgen.py"


class TimedDetector:
    """What ``serve_http`` is handed: the ``RetrievalDetector`` with a
    span around each dispatch."""

    def __init__(self, inner, spans):
        self.inner = inner
        self.spans = spans
        self.device = inner.device

    @property
    def classes(self):
        return self.inner.classes

    def detect(self, images):
        with self.spans.span("detect_dispatch", batch=int(images.shape[0])):
            return self.inner.detect(images)

    def reload_delegates(self, strict: bool = False) -> int:
        return self.inner.reload_delegates(strict)


def gallery_crops(seed: int, n_classes: int, per_class: int, size: int):
    """uint8 crops [N, size, size, 3] and their class labels."""
    crops, labels = [], []
    for c in range(n_classes):
        for j in range(per_class):
            rng = imgs.rng_for(seed, 10, c * per_class + j)
            crops.append(imgs.synthetic_crop(rng, imgs.class_color(c),
                                             size, size))
            labels.append(c)
    return np.stack(crops), np.array(labels)


def clip_normalise(crops: np.ndarray) -> np.ndarray:
    from reference.detect import CLIP_MEAN, CLIP_STD

    x = crops.astype(np.float32) / 255.0
    return (x - np.array(CLIP_MEAN, np.float32)) / np.array(CLIP_STD,
                                                            np.float32)


def class_name(c: int) -> str:
    return f"class_{c:03d}"


def upload_pool(seed: int, p: dict, n_classes: int) -> list[bytes]:
    """``photos_per_size`` seeded product photos of each size, as JPEG."""
    pool = []
    for s, (h, w) in enumerate(p["photo_sizes"]):
        for j in range(p["photos_per_size"]):
            rng = imgs.rng_for(seed, 20 + s, j)
            color = imgs.class_color(int(rng.integers(n_classes)))
            pool.append(imgs.jpeg(imgs.product_photo(rng, color, h, w),
                                  p["jpeg_quality"]))
    return pool


def schedule(seed: int, rate: float, seconds: float, pool_size: int,
             tag: int = 2):
    """(due offsets in seconds, pool index) of every request of the
    window: the count fixed by the rate; the gaps between arrivals the
    same exponential quantiles for every seed (a Poisson process's), in a
    seeded order, scaled to span the window; pool entries used equally
    in a seeded order. Seeds change the order of the work, not its
    amount or its burstiness."""
    rng = imgs.rng_for(seed, tag, 0)
    n = max(1, int(round(rate * seconds)))
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n))
    offsets = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    offsets *= seconds / gaps.sum()
    order = rng.permutation(np.arange(n) % pool_size)
    return [[float(t), int(b)] for t, b in zip(offsets, order)]


def post(port: int, body: bytes) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/detect", body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def build_service(run):
    """Set-up up to a warmed, listening server → (server, port, wrapper,
    detector, uploads, crops, labels, state)."""
    torch = run.torch
    from retrieval_based_object_detection_tpu_torch.gallery.store import (
        Gallery,
    )
    from retrieval_based_object_detection_tpu_torch.pipelines import (
        delegates as delegates_stage,
    )
    from retrieval_based_object_detection_tpu_torch.pipelines import embed
    from retrieval_based_object_detection_tpu_torch.pipelines import serve

    p, cfg = run.params, run.cfg
    pcfg = clip_config(cfg)
    state = clip_state(torch, cfg, run.seed, run.device)
    crops, labels = gallery_crops(run.seed, p["gallery_classes"],
                                  p["crops_per_class"], cfg["image_size"])
    gallery = Gallery("bench", dim=cfg["embed_dim"],
                      capacity=len(labels) + 64, device=run.device)
    encoder = embed.make_encoder(state, pcfg, p["gallery_dtype"],
                                 device=run.device)
    embed.embed_arrays(
        gallery, encoder, clip_normalise(crops),
        [f"gallery/{class_name(c)}/{i}.jpg" for i, c in enumerate(labels)],
        [class_name(c) for c in labels], batch_size=cfg["embed_batch"])
    del encoder
    delegates_stage.build_delegates(gallery, cases=[p["case"]])
    detector = serve.RetrievalDetector(
        clip_params=state, gallery=gallery, clip_config=pcfg,
        delegate_type=p["delegate_type"], case=p["case"],
        max_boxes=p["max_boxes"], device=run.device)
    wrapper = TimedDetector(detector, run.spans)
    server = serve.serve_http(wrapper, "127.0.0.1", 0,
                              serving_size=p["serving_size"],
                              max_batch=p["max_batch"],
                              batch_wait_ms=p["batch_wait_ms"])
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    uploads = upload_pool(run.seed, p, p["gallery_classes"])
    # Warm every dispatch size the micro-batcher pads to, then the HTTP
    # path with one upload of each size.
    from reference.detect import decode, letterbox

    canvas = torch.as_tensor(letterbox(decode(uploads[0]),
                                       p["serving_size"])[0],
                             device=run.device)
    sizes = sorted({s for s in (1, 2, 4, 8, 16, 32, 64)
                    if s < p["max_batch"]} | {p["max_batch"]})
    for _ in range(2):
        for s in sizes:
            wrapper.detect(canvas[None].expand(s, -1, -1, -1).contiguous())
    for j in range(0, len(uploads), p["photos_per_size"]):
        status, _ = post(port, uploads[j])
        if status != 200:
            raise RuntimeError(f"warm-up request answered {status}")
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return server, port, wrapper, detector, uploads, crops, labels, state


def drive(run, port: int, uploads: list[bytes], sched: list,
          seconds: float, workdir: str, on_start=None) -> list:
    """Send one window's schedule from a child process; → its records
    [due, sent, done, status, body] in schedule order. ``on_start(start)``
    runs on this thread once the start time (monotonic) is fixed, before
    the first request is due, and may wait into the window (the
    profiler is started and stopped on this thread)."""
    p = run.params
    bodies = []
    for i, data in enumerate(uploads):
        path = os.path.join(workdir, f"upload{i}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        bodies.append(path)
    spec_path = os.path.join(workdir, "loadgen.json")
    out_path = os.path.join(workdir, "records.json")
    with open(spec_path, "w") as f:
        json.dump({"url": f"http://127.0.0.1:{port}/detect",
                   "bodies": bodies, "requests": sched,
                   "threads": p["sender_threads"],
                   "timeout_s": p["timeout_s"], "out": out_path}, f)
    child = subprocess.Popen([sys.executable, str(LOADGEN), spec_path],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             text=True)
    try:
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        start = time.monotonic() + 0.25
        child.stdin.write(f"{start!r}\n")
        child.stdin.flush()
        if on_start is not None:
            on_start(start)
        child.wait(timeout=seconds + p["timeout_s"] + 120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise RuntimeError(f"the load generator exited {child.returncode}")
    with open(out_path) as f:
        return json.load(f)


def latencies_ms(records) -> list[float]:
    return [(r[2] - r[0]) * 1e3 if r and r[3] == 200 else stats.FAILED_MS
            for r in records]


def slo_share(lat: list[float], slo_ms: float) -> float:
    """Percent of the requests answered within ``slo_ms`` of when they
    were due; a failed request never is."""
    return 100.0 * sum(1 for x in lat if x <= slo_ms) / len(lat)


def judge(served: list, ref: list, classes: list[str]) -> dict:
    """The compared numbers of served answers against the reference's
    answers of the same uploads (each ``reference.detect.answers``
    entry):

    - ``boxes_differing``: detections whose box or confidence is not the
      reference's, or whose count differs from the reference's gated
      count. Boxes are whole canvas pixels scaled back to the upload
      (0.01 px is float rounding); confidences are the same f32 sums
      (1e-4 is rounding). An exact comparison.
    - ``sim_gap``: the widest gap by which the reference's cosine of the
      served class lies below the reference's best class, or the served
      similarity lies from the reference's cosine of the served class.
    An answer that is missing reads ``MISSING`` in both."""
    index = {c: i for i, c in enumerate(classes)}
    differing, gap = 0, 0.0
    for ans, r in zip(served, ref):
        if ans is None:
            return {"boxes_differing": MISSING, "sim_gap": MISSING}
        dets = ans.get("detections") or []
        keep = [k for k in range(r["box"].shape[0])
                if k == 0 or r["conf"][k] >= CONF_THRESHOLD]
        differing += abs(len(dets) - len(keep))
        for d, k in zip(dets, keep):
            differing += bool(
                np.abs(np.array(d["box"]) - r["box"][k]).max() > 0.01
                or abs(d["confidence"] - float(r["conf"][k])) > 1e-4)
            c = index.get(d["class_name"])
            if c is None:
                gap = MISSING
                continue
            sims = r["sims"][k]
            gap = max(gap, float(sims.max() - sims[c]),
                      abs(d["similarity"] - float(sims[c])))
    return {"boxes_differing": differing, "sim_gap": gap}


# RetrievalDetector's confidence gate (its default).
CONF_THRESHOLD = 0.25


def reference_answers(run, uploads, crops, labels, state, mm=None,
                      dtype=None):
    """The reference's answers to ``uploads``, its delegates made from
    the same gallery crops; → (answers, class names)."""
    torch = run.torch
    from reference import detect as ref

    p, cfg = run.params, run.cfg
    dtype = dtype or torch.float32
    x = torch.as_tensor(clip_normalise(crops), device=run.device)
    dmat = ref.delegates(state, cfg, x, labels, p["gallery_classes"], mm=mm)
    del x
    out = ref.answers(uploads, state, cfg, dmat, p["serving_size"],
                      p["max_boxes"], run.device, mm=mm, dtype=dtype)
    return out, [class_name(c) for c in range(p["gallery_classes"])]


def traced_segment(run, prof, port, uploads, workdir):
    """With ``--trace 1``: after the window, ``trace_seconds`` more of the
    same load under the profiler, which slows every launch; the window's
    own numbers are taken without it. → the trace's summary or None."""
    if prof is None:
        return None
    p = run.params

    def opens(start):
        time.sleep(max(0.0, start - time.monotonic()))
        prof.start()

    drive(run, port, uploads, schedule(
        run.seed, p["rate_per_s"], p["trace_seconds"], len(uploads), 5),
        p["trace_seconds"], workdir, opens)
    return prof.stop()


def _mean_ms(spans) -> float | None:
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None


def check_sample(run, n_requests: int) -> np.ndarray:
    rng = imgs.rng_for(run.seed, 3, 0)
    k = min(run.params["check_requests"], n_requests)
    return np.sort(rng.choice(n_requests, k, replace=False))


def run(run) -> Outcome:
    torch = run.torch
    p = run.params
    server, port, wrapper, detector, uploads, crops, labels, state = \
        build_service(run)
    workdir = tempfile.mkdtemp(prefix="pb-detect-")
    prof = run.profiler()

    def window_opens(start):
        run.spans.reset()
        run.setup_s = time.perf_counter() - run.t_process + (
            start - time.monotonic())

    try:
        # Load at the cell's rate before the window, as set-up: the first
        # seconds under concurrent load run slower than the rest.
        drive(run, port, uploads, schedule(
            run.seed, p["rate_per_s"], p["warm_seconds"], len(uploads), 4),
            p["warm_seconds"], workdir)
        t_window = time.perf_counter()
        sched = schedule(run.seed, p["rate_per_s"], run.seconds,
                         len(uploads))
        records = drive(run, port, uploads, sched, run.seconds, workdir,
                        window_opens)
        t_end = time.perf_counter()
        dispatches = run.spans.of("detect_dispatch")
        device = device_block(torch, run.device, run.spec["chips"])
        trace = traced_segment(run, prof, port, uploads, workdir)
    finally:
        server.shutdown()
        server.server_close()
        shutil.rmtree(workdir, ignore_errors=True)
    lat = latencies_ms(records)
    ok = [r for r in records if r and r[3] == 200]
    failed = len(records) - len(ok)
    late = sorted((r[1] - r[0]) * 1e3 for r in records if r)
    quarter = max(1, len(lat) // 4)
    run.log(requests=len(records), completed=len(ok), failed=failed,
            p50_ms=stats.percentile(lat, 50),
            p95_ms=stats.percentile(lat, 95), max_ms=max(lat),
            slo_share=slo_share(lat, p["slo_ms"]),
            first_quarter_p50_ms=stats.percentile(lat[:quarter], 50),
            last_quarter_p50_ms=stats.percentile(lat[-quarter:], 50),
            sender_late_p50_ms=stats.percentile(late, 50),
            sender_late_max_ms=late[-1],
            rate_per_s=p["rate_per_s"])
    if trace is not None:
        # The profiler slows every launch: the traced segment's dispatches
        # beside the window's say how far its load regime departs.
        traced = trace.inside(run.spans.of("detect_dispatch"))
        n_traced = len(schedule(run.seed, p["rate_per_s"],
                                p["trace_seconds"], len(uploads), 5))
        run.log(window_requests_per_dispatch=len(ok) / max(1, len(dispatches)),
                window_dispatch_ms=_mean_ms(dispatches),
                traced_requests_per_dispatch=n_traced / max(1, len(traced)),
                traced_dispatch_ms=_mean_ms(traced))
    layer = {"traffic": "detect_http", "cfg": run.cfg, "params": p,
             "requests_ok": len(ok), "latencies_ms": lat,
             "dispatches": dispatches,
             "traced_dispatches": run.spans.of("detect_dispatch"),
             "trace": trace, "window_s": t_end - t_window}
    # The check, once the program's state is freed.
    sample = check_sample(run, len(records))
    served = []
    for i in sample:
        r = records[i]
        served.append(json.loads(r[4]) if r and r[3] == 200 else None)
    sampled_uploads = [uploads[sched[i][1]] for i in sample]
    del detector, wrapper, server
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref, classes = reference_answers(run, sampled_uploads, crops, labels,
                                     state)
    nums = judge(served, ref, classes)
    checks = [run.check("failed_requests", failed)]
    checks += [run.check(k, v) for k, v in nums.items()]
    return Outcome(
        attempted=len(records), failed=failed,
        end_to_end={"detect_slo_share": (slo_share(lat, p["slo_ms"]), "%")},
        checks=checks, device=device, layer=layer)


def control(run) -> dict:
    """The control's numbers: the reference put in the program's place one
    precision below the configuration's (the tower's products in float8
    e4m3, the proposal and crop arithmetic in bf16), answering the
    uploads a window at the cell's rate would sample, judged as served
    answers are."""
    torch = run.torch
    from reference import clip
    from reference import detect as ref

    p = run.params
    uploads = upload_pool(run.seed, p, p["gallery_classes"])
    sched = schedule(run.seed, p["rate_per_s"], run.seconds, len(uploads))
    sampled = [uploads[sched[i][1]] for i in check_sample(run, len(sched))]
    crops, labels = gallery_crops(run.seed, p["gallery_classes"],
                                  p["crops_per_class"],
                                  run.cfg["image_size"])
    state = clip_state(torch, run.cfg, run.seed, run.device)
    low, classes = reference_answers(run, sampled, crops, labels, state,
                                     mm=clip.fp8_mm, dtype=torch.bfloat16)
    served = [ref.as_served(a, classes, CONF_THRESHOLD) for a in low]
    want, classes = reference_answers(run, sampled, crops, labels, state)
    return {"failed_requests": 0, **judge(served, want, classes)}
