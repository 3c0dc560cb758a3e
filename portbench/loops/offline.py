"""Closed loop of one client calling ``SVCPipeline.convert`` back to back,
as the CLI converts a folder of songs: each clip is handed over as the
waveform a WAV reader gives. The window closes when the conversion that
started last has returned."""

from __future__ import annotations

import time


def run(r) -> None:
    t0 = r.start_window()
    end, i = t0 + r.seconds, 0
    while time.perf_counter() < end:
        req = r.requests[i % len(r.requests)]
        res = r.new_result(req, time.perf_counter())
        try:
            res.output = r.proxy.convert(r.audio(req), req.singer, request=i)
        except Exception as e:  # noqa: BLE001 - a failed conversion counts in `failed`
            res.error = f"{type(e).__name__}: {e}"
        res.t_done = time.perf_counter()
        i += 1
    r.close_window()
