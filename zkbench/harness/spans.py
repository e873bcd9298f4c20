"""The benchmark's own spans, around calls into the program's layers.

A span wraps the attribute its caller looks up (a module's function, a class's
method or classmethod) and records the host clock (``time.time_ns``) at the
call's start and end, each taken after a ``torch.cuda.synchronize()`` when
``sync`` is set, so that a span holds its own device work. They are installed
only in a traced run and taken out before the run's check.
"""

from __future__ import annotations

import collections
import functools
import importlib
import time

import torch


class Spans:
    def __init__(self, sync: bool):
        self.sync = sync
        self.records: dict[str, list[tuple[int, int]]] = collections.defaultdict(list)
        self._undo: list[tuple[object, str, object]] = []

    def _wrap(self, name: str, fn):
        records = self.records[name]
        sync = self.sync

        @functools.wraps(fn)
        def span(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            start = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                if sync:
                    torch.cuda.synchronize()
                records.append((start, time.time_ns()))

        return span

    def install(self, name: str, target: str) -> None:
        """``target`` is ``"package.module:attribute"`` or
        ``"package.module:Class.attribute"``."""
        module_name, path = target.split(":")
        owner = importlib.import_module(module_name)
        *outer, attr = path.split(".")
        for part in outer:
            owner = getattr(owner, part)
        raw = vars(owner)[attr]
        if isinstance(raw, (classmethod, staticmethod)):
            wrapped = type(raw)(self._wrap(name, raw.__func__))
        else:
            wrapped = self._wrap(name, raw)
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, raw))

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, raw = self._undo.pop()
            setattr(owner, attr, raw)
