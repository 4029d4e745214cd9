"""A sample of the windowed-BA solves that the timed path runs, kept for the
reference.

The handler assembles each solve's problem on the host and solves it on the
device in ``hso_tpu_torch.pipeline.ba_glue.run_local_ba``: on a card through
``captured_local_ba`` (a captured graph), elsewhere by calling
``local_bundle_adjustment``.  While the tap is on, it wraps that one call,
passes every argument and result through untouched, and keeps device copies
of a reservoir sample of ``k`` solves, drawn from the seed: the problem as the
solver got it and the solver's answer.  A copy is a few device-to-device
copies of about a megabyte, made only for a solve that enters the sample.
"""

from __future__ import annotations

import numpy as np
import torch


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_copy(v) for v in x)
    return x


class Tap:
    def __init__(self, k: int, seed: int, on_card: bool):
        self.k, self.on_card = int(k), bool(on_card)
        self.rng = np.random.default_rng([int(seed), 2])
        self.on = False
        self.count = 0          #: solves seen while on
        self.kept: list[dict] = []
        self._saved = None

    def _see(self, args, kw, out):
        if self.on:
            n = self.count
            self.count += 1
            slot = n if n < self.k else int(self.rng.integers(0, n + 1))
            if slot < self.k:
                item = dict(args=_copy(args), kw=dict(kw),
                            out={key: out[key].detach().clone() for key in ("T_kf", "idist")})
                if slot == len(self.kept):
                    self.kept.append(item)
                else:
                    self.kept[slot] = item
        return out

    def install(self) -> None:
        from hso_tpu_torch.pipeline import ba_glue

        if self.on_card:
            name, orig = "captured_local_ba", ba_glue.captured_local_ba

            def wrapped(cache, device, **kw):
                solve = orig(cache, device, **kw)
                return lambda *a: self._see(a, kw, solve(*a))
        else:
            name, orig = "local_bundle_adjustment", ba_glue.local_bundle_adjustment

            def wrapped(*a, **kw):
                return self._see(a, kw, orig(*a, **kw))
        self._saved = (ba_glue, name, orig)
        setattr(ba_glue, name, wrapped)

    def remove(self) -> None:
        if self._saved is not None:
            mod, name, orig = self._saved
            setattr(mod, name, orig)
            self._saved = None
