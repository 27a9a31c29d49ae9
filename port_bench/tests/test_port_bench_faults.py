"""A whole run of each cell on the CPU at a tiny size, the look for a
card skipped: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false. The faults a cell can have: an
answer altered where it is produced, and half of a batch left out (its
places filled with the other half's answers). Single-card cells have no
exchange between chips, and none keeps state across steps."""

from __future__ import annotations

import numpy as np
import pytest

DETECT, SEARCH, EMBED = ("vitb32-detect-steady", "vitb32-search-1m",
                         "vitb32-embed-tree")


def failed_numbers(line):
    return [k for k, c in line["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", [DETECT, EMBED])
def test_sound_runs_are_correct(tiny_cell, cell):
    line = tiny_cell(cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    if cell == DETECT:
        assert 0 < line["metrics"]["detect_slo_share"]["value"] <= 100


def test_sound_search_is_correct(tiny_cell, int8_on_cpu):
    line = tiny_cell(SEARCH)
    assert line["correct"], line["checks"]


def test_traced_run_reports_per_layer_metrics(tiny_cell):
    line = tiny_cell(DETECT, trace=True)
    assert {"dispatch_size", "dispatch_ms", "step_mfu", "idle_share.detect",
            "detect_latency_p95_ms"} <= set(line["metrics"])
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert len(line["breakdown"]["device_ops"]) <= 10


# ------------------------------------------------------------------ detect
def _break_detect(monkeypatch, fault):
    from retrieval_based_object_detection_tpu_torch.pipelines import serve

    detect = serve.RetrievalDetector.detect

    def broken(self, images):
        out = detect(self, images)
        if fault == "altered":
            out[0]["detections"][0]["similarity"] += 0.25
            out[0]["similarity"] = out[0]["detections"][0]["similarity"]
        elif len(out) > 1:
            half = len(out) // 2
            out[half:] = [out[i % half] for i in range(len(out) - half)]
        return out

    monkeypatch.setattr(serve.RetrievalDetector, "detect", broken)


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_detect_faults_are_caught(tiny_cell, monkeypatch, fault):
    _break_detect(monkeypatch, fault)
    line = tiny_cell(DETECT)
    assert not line["correct"], line["checks"]


# ------------------------------------------------------------------ search
def _break_search(monkeypatch, fault):
    from retrieval_based_object_detection_tpu_torch.gallery import store

    search = store.Gallery.search

    def broken(self, queries, *a, **kw):
        out = search(self, queries, *a, **kw)
        if fault == "altered":
            out[0][0].score += 0.01
        else:
            half = len(out) // 2
            out[half:] = out[:len(out) - half]
        return out

    monkeypatch.setattr(store.Gallery, "search", broken)


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_search_faults_are_caught(tiny_cell, int8_on_cpu, monkeypatch,
                                  fault):
    _break_search(monkeypatch, fault)
    line = tiny_cell(SEARCH)
    assert not line["correct"], line["checks"]


# ------------------------------------------------------------------- embed
def _break_embed(monkeypatch, fault):
    from retrieval_based_object_detection_tpu_torch.pipelines import embed

    make = embed.make_encoder

    def broken_make(*a, **kw):
        encode = make(*a, **kw)

        def broken(batch):
            out = np.array(encode(batch))
            if fault == "altered":
                out[::5] *= 1.01
            else:
                half = len(out) // 2
                out[half:] = out[:len(out) - half]
            return out

        return broken

    monkeypatch.setattr(embed, "make_encoder", broken_make)


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_embed_faults_are_caught(tiny_cell, monkeypatch, fault):
    _break_embed(monkeypatch, fault)
    line = tiny_cell(EMBED)
    assert not line["correct"], line["checks"]
