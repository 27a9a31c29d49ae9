"""Find a cell, its configuration, its traffic kind and the per-layer
metrics by name, from files alone.

- ``workloads/<cell>.json``: one cell (config, traffic, chips, why, the
  traffic's parameters and the limits of its correctness check);
- ``configs/<config>.json``: one model configuration;
- ``traffic/<kind>.py``: one traffic kind (generator, driver, arithmetic);
- ``metrics/<metric>.py``: one per-layer metric reader.

A new cell, configuration, traffic kind or metric is a new file; nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH_ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class SpecError(ValueError):
    """A name that has no file, or a file that does not hold what it
    should."""


def _path(kind: str, name: str, suffix: str, root: Path) -> Path:
    if not NAME.match(name):
        raise SpecError(f"not a valid {kind} name: {name!r}")
    path = Path(root) / kind / f"{name}{suffix}"
    if not path.is_file():
        raise SpecError(f"no {kind} named {name!r} (looked for {path})")
    return path


def load_json(kind: str, name: str, root: Path = BENCH_ROOT) -> dict:
    data = json.loads(_path(kind, name, ".json", root).read_text())
    if data.get("name") != name:
        raise SpecError(
            f"{kind}/{name}.json names itself {data.get('name')!r}")
    return data


def workload(name: str, root: Path = BENCH_ROOT) -> dict:
    spec = load_json("workloads", name, root)
    for key in ("config", "traffic", "chips", "why", "params"):
        if key not in spec:
            raise SpecError(f"workloads/{name}.json has no {key!r}")
    return spec


def config(name: str, root: Path = BENCH_ROOT) -> dict:
    return load_json("configs", name, root)


def load_module(kind: str, name: str, root: Path = BENCH_ROOT) -> ModuleType:
    """``<root>/<kind>/<name>.py`` as a module (names may hold ``.`` and
    ``-``, so it is loaded by path, under a name of its own)."""
    path = _path(kind, name, ".py", root)
    mod_name = "pb_" + kind + "__" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic(kind: str, root: Path = BENCH_ROOT) -> ModuleType:
    return load_module("traffic", kind, root)


def metric_names(root: Path = BENCH_ROOT) -> list[str]:
    return sorted(p.stem for p in (Path(root) / "metrics").glob("*.py")
                  if NAME.match(p.stem))


def metrics(root: Path = BENCH_ROOT) -> dict[str, ModuleType]:
    """Every per-layer metric reader, by name."""
    return {name: load_module("metrics", name, root)
            for name in metric_names(root)}
