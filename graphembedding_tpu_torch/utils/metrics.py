"""Structured per-step metrics (stdout + JSONL).

Reference counterpart: bare `print()` statements (SURVEY.md §6). The
BASELINE report deliverables (loss, pairs/s, walked-edges/s, scaling
efficiency) flow through here.
"""

from __future__ import annotations

import json
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None, quiet: bool = False):
        self.path = jsonl_path
        self.quiet = quiet
        self._f = open(jsonl_path, "a") if jsonl_path else None
        self.t0 = time.time()

    def log(self, **fields):
        fields.setdefault("t", round(time.time() - self.t0, 3))
        line = json.dumps(fields)
        if not self.quiet:
            print(line)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
