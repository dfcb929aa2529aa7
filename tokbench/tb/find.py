"""Finds a configuration, a traffic mix, a loop, a vocabulary builder or a
metric reader by its name, as a file of its own under the benchmark's
folder: a later cell, mix or metric is a file added, not a file edited."""

from __future__ import annotations

import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # tokbench/
REPO = os.path.dirname(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def path(kind: str, name: str, ext: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    p = os.path.join(ROOT, kind, name + ext)
    if not os.path.isfile(p):
        raise FileNotFoundError(f"no {kind} named {name!r} ({p})")
    return p


def data(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` (configs, traffic)."""
    with open(path(kind, name, ".json")) as f:
        return json.load(f)


_MODULES: dict = {}


def module(kind: str, name: str):
    """``<kind>/<name>.py`` (loops, vocabs, metrics), loaded once."""
    if (kind, name) in _MODULES:
        return _MODULES[kind, name]
    p = path(kind, name, ".py")
    mod_name = "tokbench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _MODULES[kind, name] = mod
    return mod


def benchmark(root: str = REPO) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)
