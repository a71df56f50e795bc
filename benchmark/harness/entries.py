"""How a traffic mix drives the program: one class per entry point of
the PyTorch and CUDA port that a mix can name (``entry``), each making
the calls of a closed loop and, on the calls the check samples, keeping
what the call produced for the comparison with the plain reference.

``stitch``: ``Stitcher.stitch`` on one frame set a call, the u8 panorama
back on the host. A sampled call also keeps its features (``prepare``),
the ordering's match counts and the edge plan, taken where the stitcher
calls them; nothing is recomputed, and what is on the device stays there
until the window has closed (``host``).

``batch_chain``: ``parallel.batched.batched_stitch_chain`` on ``batch``
chain-ordered frame sets a call, on its default fixed canvas, the
canvases read back as u8 (what a photo service hands back). A sampled
member keeps its canvas and plan rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def replace_config(cfg, overrides: dict):
    """``cfg`` (a frozen dataclass) with ``overrides`` applied, nested
    groups as nested dicts."""
    changes = {}
    for key, value in overrides.items():
        if not hasattr(cfg, key):
            raise KeyError(f"{type(cfg).__name__} has no field {key!r}")
        cur = getattr(cfg, key)
        changes[key] = (replace_config(cur, value)
                        if dataclasses.is_dataclass(cur) else value)
    return dataclasses.replace(cfg, **changes)


def port_config(overrides: dict):
    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    return replace_config(DEFAULT_CONFIG, overrides)


class Stitch:
    """``Stitcher.stitch``, one panorama a call."""

    def __init__(self, cfg, device, mix: dict):
        from computervisionimagestich2_tpu_torch.models import stitcher
        self.module = stitcher
        self.st = stitcher.Stitcher(cfg, device)
        self.stage_sums: dict[str, float] = {}
        self._rec: dict | None = None
        prepare = self.st.prepare
        counts_fn = stitcher.all_pairs_match_counts
        plan_fn = stitcher.plan_edges_with_rows

        def prepare_rec(images):
            out = prepare(images)
            if self._rec is not None:
                self._rec["features"] = out[1]
            return out

        def counts_rec(*args, **kwargs):
            out = counts_fn(*args, **kwargs)
            if self._rec is not None:
                self._rec["counts"] = out
            return out

        def plan_rec(feats, edges, *args, **kwargs):
            out = plan_fn(feats, edges, *args, **kwargs)
            if self._rec is not None:
                self._rec["edges"] = [tuple(e) for e in edges]
                self._rec["plan"] = out[0]
            return out

        self.st.prepare = prepare_rec
        stitcher.all_pairs_match_counts = counts_rec
        stitcher.plan_edges_with_rows = plan_rec
        self._restore = (counts_fn, plan_fn)

    def panoramas_per_call(self, mix: dict) -> int:
        return 1

    def call(self, sets: list[np.ndarray], record: bool):
        """One stitch of ``sets[0]``; returns the kept record or None."""
        # a stitch whose ordering finds no edge plans nothing
        self._rec = {"edges": [], "plan": np.zeros((0, 23), np.float32)} \
            if record else None
        pano = self.st.stitch(list(sets[0]))
        for k, v in self.st.stage_times.items():
            self.stage_sums[k] = self.stage_sums.get(k, 0.0) + v
        rec, self._rec = self._rec, None
        if rec is None:
            return None
        rec["panorama"] = pano
        return [rec]

    @staticmethod
    def host(rec: dict) -> dict:
        """A record's device tensors copied to the host, once the window
        has closed."""
        return dict(rec, features=[[t.detach().cpu() for t in f]
                                   for f in rec["features"]],
                    counts=rec["counts"].cpu())

    def close(self) -> None:
        self.module.all_pairs_match_counts, self.module.plan_edges_with_rows = \
            self._restore
        self.st = None


class BatchChain:
    """``batched_stitch_chain`` on ``batch`` frame sets a call."""

    def __init__(self, cfg, device, mix: dict):
        from computervisionimagestich2_tpu_torch.parallel import batched
        self.batched = batched
        self.cfg = cfg
        self.device = device
        self.stage_sums: dict[str, float] = {}

    def panoramas_per_call(self, mix: dict) -> int:
        return int(mix["batch"])

    def call(self, sets: list[np.ndarray], record: bool):
        canvases, plans = self.batched.batched_stitch_chain(
            np.stack(sets), self.cfg, device=self.device)
        canvases = canvases.to(torch.uint8).cpu().numpy()
        if not record:
            return None
        return [{"canvas": c, "plan": p} for c, p in zip(canvases, plans)]

    @staticmethod
    def host(rec: dict) -> dict:
        return rec

    def close(self) -> None:
        pass


ENTRIES = {"stitch": Stitch, "batch_chain": BatchChain}
