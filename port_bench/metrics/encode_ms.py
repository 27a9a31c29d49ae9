"""``encode_ms``: mean host-clock time of one encoder call inside
``embed_tree`` (a batch of ``embed_batch`` crops through the f32 tower,
back to the host), from the harness's wrapper of the encoder. Moves
``embed_crops_per_s``."""

UNIT = "ms"


def read(layer: dict):
    if layer.get("traffic") != "embed_tree" or not layer["encodes"]:
        return None
    spans = layer["encodes"]
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
