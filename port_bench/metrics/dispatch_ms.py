"""``dispatch_ms``: mean host-clock time of one ``RetrievalDetector.detect``
dispatch (``detect_embed_classify``: proposals, crops, the bf16 tower,
the cosine), from the harness's wrapper. A dispatch ends in copies to
the host, so it is synchronised. Moves ``detect_slo_share``."""

UNIT = "ms"


def read(layer: dict):
    if layer.get("traffic") != "detect_http" or not layer["dispatches"]:
        return None
    spans = layer["dispatches"]
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
