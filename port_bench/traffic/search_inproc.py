"""Traffic kind ``search_inproc``: an application that holds the gallery
in process and searches it from ``callers`` threads (``Gallery.search``,
the way most deployments embed it).

Set-up: ``rows`` seeded f32 rows of ``dim`` on the card, each with a
class out of ``classes`` and one of ``data_types``, upserted with their
payloads; one warm search of every filter the window uses (the device
mirrors, the int8 quantisation and each filter's device mask are built
then); a pool of seeded calls for each caller.

Window: ``callers`` threads call back to back, closed loop with no think
time, for ``seconds``. A call is ``queries_per_call`` queries, each a
gallery row plus ``noise_sigma`` of the rows' σ of noise, and one filter:
every even call one ``class_name`` (the sources from that class), every
odd call one ``data_type``; ``Gallery.search(q, k, flt, exact=False)``, so
that the automatic route takes the int8 tier (B2 and the f32 rescore).

End to end: ``search_p95_ms`` over every call of the window, from its
call to its return.

Check: a seeded sample of the calls, against the exact f32 cosine top-k
of ``reference.search`` over the same rows: each served score against
the reference's score of that row, each served rank's reference score
below the reference's score at that rank, and hits outside the filter.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from benchcore import images as imgs
from benchcore import stats
from benchcore.context import MISSING, Outcome
from benchcore.device import device_block
from benchcore.images import SEED_MASK


def make_rows(torch, seed: int, p: dict, device):
    """(rows [N, D] f32, class ids [N], data-type ids [N]) on ``device``,
    from ``seed`` in three calls of one generator on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    n, d = p["rows"], p["dim"]
    rows = torch.randn(n, d, generator=gen, device=device)
    cls = torch.randint(0, p["classes"], (n,), generator=gen, device=device)
    dt = torch.randint(0, len(p["data_types"]), (n,), generator=gen,
                       device=device)
    return rows, cls, dt


def make_calls(torch, seed: int, p: dict, rows, cls_np, dt_np):
    """Per caller, ``calls_per_caller`` calls: (queries [Q, D] f32 numpy,
    filter field, filter value)."""
    by_class = [np.flatnonzero(cls_np == c) for c in range(p["classes"])]
    by_dt = [np.flatnonzero(dt_np == t) for t in range(len(p["data_types"]))]
    q = p["queries_per_call"]
    specs, sources = [], []
    for caller in range(p["callers"]):
        for j in range(p["calls_per_caller"]):
            rng = imgs.rng_for(seed, 100 + caller, j)
            if j % 2 == 0:
                c = int(rng.integers(p["classes"]))
                specs.append((caller, "class_name", f"class_{c:03d}"))
                sources.append(rng.choice(by_class[c], q))
            else:
                t = int(rng.integers(len(p["data_types"])))
                specs.append((caller, "data_type", p["data_types"][t]))
                sources.append(rng.choice(by_dt[t], q))
    gen = torch.Generator(device=rows.device)
    gen.manual_seed((int(seed) + 1) & SEED_MASK)
    src = torch.as_tensor(np.concatenate(sources), device=rows.device)
    noise = torch.randn(src.shape[0], rows.shape[1], generator=gen,
                        device=rows.device)
    queries = (rows[src] + p["noise_sigma"] * noise).cpu().numpy()
    calls: list[list] = [[] for _ in range(p["callers"])]
    for i, (caller, field, value) in enumerate(specs):
        calls[caller].append((queries[i * q:(i + 1) * q], field, value))
    return calls


def build_gallery(run, rows, cls, dt):
    from retrieval_based_object_detection_tpu_torch.gallery.schema import (
        Payload,
    )
    from retrieval_based_object_detection_tpu_torch.gallery.store import (
        Gallery,
    )

    p = run.params
    n = rows.shape[0]
    gallery = Gallery("bench", dim=p["dim"], capacity=n, device=run.device)
    cls_np, dt_np = cls.cpu().numpy(), dt.cpu().numpy()
    chunk = 1 << 16
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        names = [f"class_{c:03d}" for c in cls_np[lo:hi]]
        types = [p["data_types"][t] for t in dt_np[lo:hi]]
        gallery.upsert(
            [f"r{i}" for i in range(lo, hi)], rows[lo:hi].cpu().numpy(),
            [Payload(data_type=t, class_name=c,
                     img_path=f"crops/{c}/{i}.jpg")
             for i, c, t in zip(range(lo, hi), names, types)])
    return gallery, cls_np, dt_np


def flt_of(field: str, value: str):
    from retrieval_based_object_detection_tpu_torch.gallery.schema import (
        Filter,
    )

    return Filter(must={field: value})


def judge(torch, served: list, calls: list, rows, cls, dt, p: dict) -> dict:
    """The compared numbers of served hit lists against the exact
    filtered cosine top-k (``reference.search``): widest score gap,
    widest gap of a served rank below the reference's score at that
    rank, and hits outside the filter."""
    from reference import search as ref

    k = p["k"]
    score = rank = 0.0
    outside = 0
    for hits, (queries, field, value) in zip(served, calls):
        if hits is None:
            return {"score": MISSING, "rank_gap": MISSING,
                    "outside_filter": MISSING}
        q = torch.as_tensor(queries, device=rows.device)
        if field == "class_name":
            mask = cls == int(value.split("_")[1])
        else:
            mask = dt == p["data_types"].index(value)
        want, _ = ref.topk(rows, q, mask, k)
        for qi, got in enumerate(hits):
            if len(got) < min(k, int(mask.sum())):
                return {"score": MISSING, "rank_gap": MISSING,
                        "outside_filter": MISSING}
            idx = torch.tensor([[int(h[0][1:]) for h in got]],
                               device=rows.device)
            exact = ref.scores_of(rows, q[qi:qi + 1], idx)[0].cpu().numpy()
            w = want[qi].cpu().numpy()
            for r, (hid, hscore, hfield) in enumerate(got):
                score = max(score, abs(hscore - float(exact[r])))
                rank = max(rank, float(w[r] - exact[r]))
                outside += hfield != value
    return {"score": score, "rank_gap": rank, "outside_filter": outside}


def compact(results, field: str) -> list:
    """A served hit list as (id, score, the filtered field's value)."""
    return [[(h.id, h.score, getattr(h.payload, field)) for h in hits]
            for hits in results]


def checked_calls(run, calls) -> list[set]:
    """Per caller, the pool indices whose first answer the check keeps: a
    seeded sample of ``check_calls`` in all. Only those answers are kept
    through the window, so that the harness adds little to the
    interpreter's garbage collection there."""
    rng = imgs.rng_for(run.seed, 3, 0)
    per = max(1, run.params["check_calls"] // len(calls))
    return [set(rng.choice(len(mine), min(per, len(mine)), replace=False)
                .tolist()) for mine in calls]


def callers_for(run, gallery, calls, filters, seconds: float,
                errors: list, keep=None) -> tuple[list, float]:
    """``len(calls)`` threads call back to back for ``seconds``; → each
    caller's (start, end, pool index, hits or None, field) records, the
    hits kept only for the first call of each pool index in ``keep``,
    and the seconds from the start to the last return."""
    p = run.params
    keep = keep or [set() for _ in calls]
    done: list[list] = [[] for _ in calls]
    barrier = threading.Barrier(len(calls) + 1)
    stop_at = [0.0]

    def caller(c: int):
        mine, out = calls[c], done[c]
        barrier.wait()
        j = 0
        while time.perf_counter() < stop_at[0]:
            queries, f, v = mine[j % len(mine)]
            with run.spans.span("search", caller=c):
                t0 = time.perf_counter()
                try:
                    hits = gallery.search(queries, k=p["k"],
                                          flt=filters[(f, v)], exact=False)
                except Exception as e:  # a failed call, counted
                    hits = None
                    errors.append(f"{type(e).__name__}: {e}")
                t1 = time.perf_counter()
            kept = hits if hits is None or (
                j < len(mine) and j in keep[c]) else ()
            out.append((t0, t1, j % len(mine), kept, f))
            j += 1

    threads = [threading.Thread(target=caller, args=(c,))
               for c in range(len(calls))]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    stop_at[0] = t0 + seconds
    barrier.wait()
    for t in threads:
        t.join()
    return done, time.perf_counter() - t0


def run(run) -> Outcome:
    torch = run.torch
    p = run.params
    rows, cls, dt = make_rows(torch, run.seed, p, run.device)
    gallery, cls_np, dt_np = build_gallery(run, rows, cls, dt)
    calls = make_calls(torch, run.seed, p, rows, cls_np, dt_np)
    del rows, cls, dt
    filters = {(f, v): flt_of(f, v) for per in calls for _, f, v in per}
    for (f, v), flt in filters.items():      # mirrors, int8, every mask
        gallery.search(calls[0][0][0], k=p["k"], flt=flt, exact=False)
    for per in calls:
        for queries, f, v in per[:4]:
            gallery.search(queries, k=p["k"], flt=filters[(f, v)],
                           exact=False)
    if run.device.type == "cuda":
        torch.cuda.synchronize()

    prof = run.profiler()
    errors: list[str] = []
    run.spans.reset()
    run.setup_done()
    done, window_s = callers_for(run, gallery, calls, filters, run.seconds,
                                 errors, checked_calls(run, calls))
    device = device_block(torch, run.device, run.spec["chips"])
    window_calls = run.spans.of("search")
    trace = None
    if prof is not None:
        # After the window, trace_seconds more of the same calls under the
        # profiler, which slows every launch; stopped once the callers
        # have returned, with the card quiet.
        prof.start()
        callers_for(run, gallery, calls, filters, p["trace_seconds"], [])
        trace = prof.stop()
    lat = [(e[1] - e[0]) * 1e3 if e[3] is not None else stats.FAILED_MS
           for per in done for e in per]
    run.log(calls=len(lat), failed=len(errors), first_error=errors[:1],
            p50_ms=stats.percentile(lat, 50),
            p95_ms=stats.percentile(lat, 95), max_ms=max(lat),
            calls_per_s=len(lat) / window_s)
    layer = {"traffic": "search_inproc", "cfg": run.cfg, "params": p,
             "calls": window_calls, "traced_calls": run.spans.of("search"),
             "rows": p["rows"],
             "dim": p["dim"], "trace": trace}
    # The check, once the program's state is freed: the kept answers
    # (and any call that failed).
    flat = [(c, e) for c, per in enumerate(done) for e in per
            if e[3] is None or len(e[3])]
    served = [None if e[3] is None else compact(e[3], e[4])
              for _, e in flat]
    asked = [calls[c][e[2]] for c, e in flat]
    del gallery, done, flat
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    rows, cls, dt = make_rows(torch, run.seed, p, run.device)
    nums = judge(torch, served, asked, rows, cls, dt, p)
    checks = [run.check("failed_calls", len(errors))]
    checks += [run.check(k, v) for k, v in nums.items()]
    return Outcome(
        attempted=len(lat), failed=len(errors),
        end_to_end={"search_p95_ms": (stats.percentile(lat, 95), "ms")},
        checks=checks, device=device, layer=layer)


def control(run) -> dict:
    """The control's numbers: the reference in bf16 (rows, queries and
    scores) put in the program's place on a seeded sample of the calls
    the callers would make, judged as served hits are."""
    torch = run.torch
    from reference import search as ref

    p = run.params
    rows, cls, dt = make_rows(torch, run.seed, p, run.device)
    calls = make_calls(torch, run.seed, p, rows, cls.cpu().numpy(),
                       dt.cpu().numpy())
    asked = [calls[c][j] for c, picked in enumerate(checked_calls(run, calls))
             for j in sorted(picked)]
    served = []
    for queries, field, value in asked:
        q = torch.as_tensor(queries, device=rows.device)
        mask = (cls == int(value.split("_")[1]) if field == "class_name"
                else dt == p["data_types"].index(value))
        scores, idx = ref.topk(rows, q, mask, p["k"], dtype=torch.bfloat16)
        served.append([[(f"r{int(i)}", float(s), value)
                        for s, i in zip(srow, irow)]
                       for srow, irow in zip(scores.cpu(), idx.cpu())])
    return {"failed_calls": 0, **judge(torch, served, asked, rows, cls, dt,
                                       p)}
