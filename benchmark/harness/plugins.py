"""Finds the benchmark's plug-ins by name, as files of the checkout it
runs from: a configuration's ``schema`` names ``schemas/<schema>.py`` (its
generator) and ``reference/<schema>.py`` (its plain reference), a traffic
mix's ``loop`` names ``loops/<loop>.py`` (the system it builds and the
driver of its window), and a per-layer metric names
``metrics/<metric>.py`` (its reader). A later cell of another shape adds
such files; it edits none."""
from __future__ import annotations

import importlib.util
import os
import re
import sys

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
KINDS = ("schemas", "reference", "loops", "metrics")


def path_of(root: str, kind: str, name: str) -> str:
    if kind not in KINDS:
        raise ValueError(f"no plug-in kind {kind!r}")
    if not NAME.fullmatch(name):
        raise ValueError(f"not a plug-in name: {name!r}")
    return os.path.join(root, "benchmark", kind, f"{name}.py")


def load_path(path: str):
    """The module of the file at `path`, loaded once per process."""
    key = "bench_plugin_" + re.sub(r"\W", "_", os.path.abspath(path))
    module = sys.modules.get(key)
    if module is None:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no plug-in file {path}")
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[key]
            raise
    return module


def load(root: str, kind: str, name: str):
    return load_path(path_of(root, kind, name))
