"""Terminal progress bar for ``Model.fit``: a copy of
``paddle_tpu/hapi/progressbar.py``."""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, num=None, width=30, verbose=1, start=True,
                 file=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self.file = file
        self._values = {}
        self._start = time.time() if start else None

    def start(self):
        self._start = time.time()

    def update(self, current_num, values=None):
        values = values or {}
        self._values.update(values)
        msg = self._format(current_num)
        if self._verbose == 1:
            self.file.write("\r" + msg)
            if self._num is not None and current_num >= self._num:
                self.file.write("\n")
        else:
            self.file.write(msg + "\n")
        self.file.flush()

    def _format(self, current_num):
        elapsed = time.time() - (self._start or time.time())
        if self._num:
            frac = min(current_num / self._num, 1.0)
            filled = int(self._width * frac)
            bar = "=" * filled + ">" * (filled < self._width) + \
                  "." * (self._width - filled - 1)
            head = f"step {current_num}/{self._num} [{bar}]"
        else:
            head = f"step {current_num}"
        stats = " - ".join(
            f"{k}: {self._fmt_val(v)}" for k, v in self._values.items())
        per_step = elapsed / max(current_num, 1)
        return f"{head} - {per_step * 1e3:.0f}ms/step - {stats}"

    @staticmethod
    def _fmt_val(v):
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(f"{x:.4f}" for x in v) + "]"
        if isinstance(v, float):
            return f"{v:.4f}"
        return str(v)
