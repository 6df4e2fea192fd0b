"""Driver ``batch``: ``streams`` recorded sequences through
``step_general_batched``, one step after another.

Its traffic keys, besides ``pass_frames`` and ``translation_step``
(``harness/traffic.py``):

- ``stagger``: stream b's pass starts ``stagger * b`` frames after stream
  0's, so streams are in every stage at every step;
- ``sample``: among the window's steps ``from`` to ``to``, ``steps`` steps
  drawn from the seed, at each one stream drawn from the seed, and the first
  ``inits`` streams whose two-view init succeeds: the stream's state before
  and after the step, for the output checks;
- ``profile``: ``steps`` batch steps, profiled in the traced run;
- ``max_steps``: the size of the step log on the card.

End-to-end: ``agg_fps`` (frames of all streams over the window).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import trace as tr
from harness.traffic import Window, derive, draw, render, row, to_host


def where(mask: torch.Tensor, a, b):
    """Field by field ``where(mask[stream], a, b)`` over two stacked states
    (``rng`` and None fields taken from ``b``)."""
    out = []
    for name, x, y in zip(b._fields, a, b):
        if name == "rng" or y is None:
            out.append(y)
        elif hasattr(y, "_fields"):
            out.append(where(mask, x, y))
        else:
            out.append(torch.where(mask.view((-1,) + (1,) * (y.dim() - 1)), x, y))
    return type(b)(*out)


class Driver:
    def __init__(self, cfg, traffic: dict, seed: int, device, reuse: bool = False):
        from monocular_visual_odometry_tpu_torch.models import state as S
        from monocular_visual_odometry_tpu_torch.models import vo as V
        from monocular_visual_odometry_tpu_torch.ops.camera import Camera

        self.S, self.V, self.reuse = S, V, reuse
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.h, self.w = cfg.dataset.height, cfg.dataset.width
        self.setup = [("imports", time.perf_counter())]
        self.cam = Camera.create(cfg.dataset.fx, cfg.dataset.fy, cfg.dataset.cx, cfg.dataset.cy)
        B, n, lag = traffic["streams"], traffic["pass_frames"], traffic["stagger"]
        self.B, self.n = B, n
        cam = dict(fx=cfg.dataset.fx, fy=cfg.dataset.fy, cx=cfg.dataset.cx, cy=cfg.dataset.cy)
        r = render(traffic, cam, self.h, self.w, seed, device, B)
        self.frames, self.gt = r.frames, r.gt
        self.setup.append(("render", time.perf_counter()))
        # stream b is at frame (step + lag * b) % n; it restarts where that is 0
        pos = (np.arange(n)[:, None] + lag * np.arange(B)[None, :]) % n       # [n, B]
        self.pos = pos
        self.pos_dev = torch.from_numpy(pos).to(device)
        self.restart_dev = self.pos_dev == 0
        self.rows = torch.arange(B, device=device)
        self.fresh = S.stack_states([S.init_state(cfg, 0, device)] * B)
        self.pass_no = np.zeros(B, np.int64)
        self.sts = S.stack_states([S.init_state(cfg, self._key(b), device) for b in range(B)])
        self.step_no = 0
        steps = traffic["max_steps"]
        self.log = dict(T=torch.zeros((steps, B, 4, 4), device=device),
                        stage=torch.zeros((steps, B), dtype=torch.int32, device=device),
                        ok=torch.zeros((steps, B), dtype=torch.bool, device=device))
        self._step()       # the warm step: the general body captured
        self.setup.append(("states and warm step", time.perf_counter()))

    def _key(self, b: int) -> int:
        return derive(self.seed, "key", b, int(self.pass_no[b]))

    def _step(self, keep=None):
        s, S, V = self.step_no, self.S, self.V
        r = s % self.n
        if s > 0 and (self.pos[r] == 0).any():
            restart = np.nonzero(self.pos[r] == 0)[0]
            self.pass_no[restart] += 1
            rng = self.sts.rng.clone()
            for b in restart:
                rng[b] = self._key(int(b))
            self.sts = where(self.restart_dev[r], self.fresh, self.sts)._replace(rng=rng)
        imgs = self.frames[self.rows, self.pos_dev[r]]
        before = self.sts
        self.sts, out = V.step_general_batched(self.cfg, self.cam, self.sts, imgs,
                                               height=self.h, width=self.w)
        self.log["T"][s].copy_(out.T_w_c)
        self.log["stage"][s].copy_(out.stage)
        self.log["ok"][s].copy_(out.tracking_ok)
        if keep is not None:
            keep(s, before, self.sts, out)
        self.step_no += 1

    def window(self, seconds: float) -> Window:
        smp = self.traffic["sample"]
        first = self.step_no
        at = {first + k for k in draw(self.seed, "sample", smp["steps"], smp["from"], smp["to"])}
        samples, inits_kept = [], []
        pick = np.random.default_rng(derive(self.seed, "streams"))

        def keep(s, before, after, out):
            if not first + smp["from"] <= s < first + smp["to"]:
                return
            # the step has waited for the card already: two small copies
            inits = ((before.stage.cpu() == self.S.STAGE_INITIALIZING)
                     & (out.stage.cpu() == self.S.STAGE_TRACKING)).nonzero().flatten().tolist()
            picked = [int(pick.integers(self.B))] if s in at else []
            for b in inits:
                if len(inits_kept) < smp["inits"] and b not in picked:
                    picked.append(b)
                    inits_kept.append(b)
            for b in picked:
                samples.append(dict(stream=b, index=int(self.pos[s % self.n, b]),
                                    before=to_host(row(before, b)), after=to_host(row(after, b)),
                                    out=to_host(row(out, b))))

        t0 = time.perf_counter()
        while True:
            if self.step_no >= self.traffic["max_steps"]:
                raise RuntimeError("batch: the window outran max_steps")
            self._step(keep)
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        steps = self.step_no - first
        return Window(t - t0, steps * self.B, np.zeros(0), self._passes(), samples)

    def end_to_end(self, win: Window) -> dict:
        return {"agg_fps": win.frames / win.seconds}

    def trace(self, profile: dict) -> dict:
        return tr.batch_trace(self, profile["steps"])

    def _passes(self) -> list:
        """Every complete pass of every stream in the log: from a restart
        (or the first step, for a stream at frame 0) through frame n - 1."""
        T = self.log["T"][:self.step_no].cpu().numpy()
        stage = self.log["stage"][:self.step_no].cpu().numpy()
        ok = self.log["ok"][:self.step_no].cpu().numpy()
        out = []
        for b in range(self.B):
            starts = [s for s in range(self.step_no) if self.pos[s % self.n, b] == 0]
            for s0 in starts:
                if s0 + self.n <= self.step_no:
                    sl = slice(s0, s0 + self.n)
                    out.append((b, T[sl, b].astype(np.float64), stage[sl, b], ok[sl, b]))
        return out

    def frame(self, stream: int, index: int) -> np.ndarray:
        return self.frames[stream, index].cpu().numpy()

    def free(self) -> None:
        self.sts = self.fresh = None
        if not self.reuse:   # reuse=True: the captured step stays for the next driver
            self.V.release_batched()
