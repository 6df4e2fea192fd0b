"""Driver ``live``: one camera stream in a closed loop through
``VOEngine.add_frame``, frame after frame.

Its traffic keys, besides ``pass_frames`` and ``translation_step``
(``harness/traffic.py``):

- ``warm_frames``: frames of the warm pass in set-up, continued until the
  tracking program has run; then ``warm_seconds`` more of the stream's
  frames, until the frame time is steady;
- ``sample``: in each of the first ``passes`` passes, ``frames`` frames from
  ``from`` on (drawn from the seed) and the frame whose two-view init
  succeeds: the stream's state before and after each, for the output checks;
- ``profile``: ``frames`` frames of a fresh pass, profiled in the traced run.

End-to-end: ``fps`` (frames whose pose came back, over the window) and
``frame_ms_p95`` (the 95th percentile of every ``add_frame`` call).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from harness import trace as tr
from harness.traffic import Window, derive, draw, render, to_host


_ENGINES: dict = {}   # reuse=True: one engine per configuration and device, kept


class Driver:
    def __init__(self, cfg, traffic: dict, seed: int, device, reuse: bool = False):
        from monocular_visual_odometry_tpu_torch.models import state as S
        from monocular_visual_odometry_tpu_torch.models import vo as V

        self.S, self.V = S, V
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.h, self.w = cfg.dataset.height, cfg.dataset.width
        self.setup = [("imports", time.perf_counter())]
        cam = dict(fx=cfg.dataset.fx, fy=cfg.dataset.fy, cx=cfg.dataset.cx, cy=cfg.dataset.cy)
        r = render(traffic, cam, self.h, self.w, seed, device)
        self.gt = r.gt
        self.frames = r.frames[0].cpu().numpy()   # a camera hands frames over on the host
        del r
        self.n = traffic["pass_frames"]
        self.passes = 0
        self.setup.append(("render", time.perf_counter()))
        engine = _ENGINES.get((cfg, str(device))) if reuse else None
        if engine is None:
            engine = V.VOEngine(cfg, self.h, self.w, seed=self._key(), device=device)
            if reuse:
                _ENGINES[(cfg, str(device))] = engine
        else:
            engine.state = S.init_state(cfg, self._key(), device)
        self.engine = engine
        # the warm pass: the first-frame, init and tracking programs captured
        i, tracked = 0, 0
        while i < self.n and (i < traffic["warm_frames"] or tracked < 3):
            out = self.engine.add_frame(self.frames[i])
            tracked += int(out.stage) == S.STAGE_TRACKING
            i += 1
        if tracked < 3:
            raise RuntimeError(f"live: the warm pass did not reach tracking in {i} frames")
        self.setup.append((f"engine and warm pass ({i} frames)", time.perf_counter()))
        # then the stream runs on until it is steady: for the first 2-35 s of
        # sustained frames a tracking frame takes ~16.9 ms, then ~14.5 ms (seen
        # on an H100 host, pinned to one core or not)
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < traffic["warm_seconds"]:
            if i == self.n:
                self._restart(derive(self.seed, "steady", n))
                i = 0
            self.engine.add_frame(self.frames[i])
            i, n = i + 1, n + 1
        # the window's passes take keys 0, 1, ... whatever the warm-up ran
        self.passes = -1
        self._restart()
        self.setup.append((f"steady ({n} frames)", time.perf_counter()))

    def _key(self) -> int:
        return derive(self.seed, "key", 0, self.passes)

    def _restart(self, key=None) -> None:
        """A fresh session: the next pass's key, or ``key``."""
        self.passes += 1
        self.engine.state = self.S.init_state(self.cfg, self._key() if key is None else key,
                                              self.device)

    def window(self, seconds: float) -> Window:
        n, eng, S = self.n, self.engine, self.S
        smp = self.traffic["sample"]
        at = {(p, f) for p in range(smp["passes"])
              for f in draw(self.seed, f"sample{p}", smp["frames"], smp["from"], n)}
        frame_ms, passes, samples = [], [], []
        est, stages, ok = np.zeros((n, 4, 4)), np.zeros(n, np.int64), np.zeros(n, bool)
        p = i = 0
        stage = S.STAGE_BLANK
        t0 = time.perf_counter()
        while True:
            if i == n:
                passes.append((0, est.copy(), stages.copy(), ok.copy()))
                self._restart()
                p, i, stage = p + 1, 0, S.STAGE_BLANK
            # the state before a drawn frame, and before every init attempt of a
            # sampled pass (kept where the init succeeds), outside the frame's time
            keep = p < smp["passes"] and ((p, i) in at or stage == S.STAGE_INITIALIZING)
            before = to_host(eng.state) if keep else None
            a = time.perf_counter()
            out = eng.add_frame(self.frames[i])
            b = time.perf_counter()
            frame_ms.append((b - a) * 1e3)
            est[i], stages[i], ok[i] = out.T_w_c.numpy(), int(out.stage), bool(out.tracking_ok)
            if keep and ((p, i) in at or int(out.stage) == S.STAGE_TRACKING):
                samples.append(dict(stream=0, index=i, before=before, after=to_host(eng.state),
                                    out=out))
            stage = int(out.stage)
            i += 1
            if b - t0 >= seconds:
                break
        return Window(b - t0, len(frame_ms), np.asarray(frame_ms), passes, samples)

    def end_to_end(self, win: Window) -> dict:
        q = np.percentile(win.frame_ms, [10, 50, 90, 99, 100])
        print("frame ms p10 p50 p90 p99 max: " + " ".join(f"{v:.2f}" for v in q),
              file=sys.stderr)
        return {"fps": win.frames / win.seconds,
                "frame_ms_p95": float(np.percentile(win.frame_ms, 95))}

    def trace(self, profile: dict) -> dict:
        return tr.live_trace(self, profile["frames"])

    def frame(self, stream: int, index: int) -> np.ndarray:
        return self.frames[index]

    def free(self) -> None:
        self.engine = None
