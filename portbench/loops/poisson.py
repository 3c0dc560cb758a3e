"""Open loop of independent users: each request is sent through
``SVCServer.convert_bytes`` at its due time, whatever is still in flight,
and timed from that due time until its WAV reply is in the client's hands.
Requests are due at the mix's arrival times within the window; the window
waits up to a minute past its end for the last replies."""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor, wait

GRACE_S = 60.0
MAX_IN_FLIGHT = 64  # client threads: more than a server with max_queue 32 and max_batch 8 can hold


def run(r) -> None:
    def send(req, res):
        try:
            res.output = r.server.convert_bytes(r.wav(req), req.singer)
        except Exception as e:  # noqa: BLE001 - sheds, timeouts and errors count in `failed`
            res.error = f"{type(e).__name__}: {e}"
        res.t_done = time.perf_counter()

    pool = ThreadPoolExecutor(max_workers=MAX_IN_FLIGHT)
    futures = []
    try:
        t0 = r.start_window()
        for req in r.requests:
            due = t0 + req.due_s
            while (now := time.perf_counter()) < due:
                time.sleep(min(due - now, 0.002))
            futures.append(pool.submit(send, req, r.new_result(req, due)))
        pending, deadline = set(futures), t0 + r.seconds + GRACE_S
        if pending:
            wait(pending, timeout=max(0.0, deadline - time.perf_counter()))
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    r.lateness_s = max((res.t_sent - res.t_due for res in r.results), default=0.0)
    r.close_window()
