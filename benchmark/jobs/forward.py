"""Forward rendering: images rendered back to back, each the mean of
``passes`` replays of the cell's render program (``harness.program``),
one key a replay drawn from the seed, each image read on the host. The
check: one image of the window, its index drawn from the seed, against
the plain reference's estimate of pixels drawn from the seed
(``check.judge``)."""
from __future__ import annotations

import time

import numpy as np

import check
import harness


class Forward:
    def __init__(self, run):
        self.run = run
        wl, self.prog, self.params = harness.program(run.bench, run.cell,
                                                     run.device)
        passes = wl["passes"]
        words, self.checked = harness.key_words(
            run.seed, (harness.KEYS + 1) * passes)
        self.keys = harness.key_tensor(words, run.device).reshape(
            harness.KEYS + 1, passes, 2)
        t = time.perf_counter()
        self.prog(self.params, self.keys[harness.KEYS, 0])
        harness.sync(run.device)
        self.capture_s = time.perf_counter() - t
        self.samples_per_step = harness.samples_per_image(wl)
        self.replays_per_step = passes
        self.min_steps = self.checked + 1
        self.excluded_s = 0.0
        self.extra = {"checked_step": self.checked}
        self.kept = None

    def warm(self):
        harness.image(self.prog, self.params, self.keys[harness.KEYS])

    def step(self, i: int) -> bool:
        if i >= harness.KEYS:
            raise RuntimeError("the window ran out of keys")
        value = harness.image(self.prog, self.params, self.keys[i])
        if i == self.checked:
            self.kept = value
        return bool(np.isfinite(value).all())

    def body(self):
        import torch
        with torch.no_grad():
            self.prog.fn(self.params, self.keys[0, 0])

    def close(self):
        del self.prog, self.params, self.keys

    def judge(self) -> dict:
        run = self.run
        return check.numbers(*check.judge(run.bench, run.cell, run.seed,
                                          self.kept, run.device))


def setup(run) -> Forward:
    return Forward(run)
