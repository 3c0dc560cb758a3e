"""Closed loop of ``clients`` clients, each sending WAV bytes through
``SVCServer.convert_bytes`` and its next request when the reply is in its
hands; requests are taken in order from the mix's pool. The window closes
when the last request sent before its end has been answered."""

from __future__ import annotations

import threading
import time


def run(r) -> None:
    lock = threading.Lock()
    nxt = [0]
    t0 = r.start_window()
    end = t0 + r.seconds

    def client():
        while True:
            with lock:
                if time.perf_counter() >= end:
                    return
                req = r.requests[nxt[0] % len(r.requests)]
                nxt[0] += 1
            body = r.wav(req)
            res = r.new_result(req, time.perf_counter())
            try:
                res.output = r.server.convert_bytes(body, req.singer)
            except Exception as e:  # noqa: BLE001 - sheds, timeouts and errors count in `failed`
                res.error = f"{type(e).__name__}: {e}"
            res.t_done = time.perf_counter()

    threads = [threading.Thread(target=client, daemon=True) for _ in range(int(r.mix["clients"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    r.close_window()
