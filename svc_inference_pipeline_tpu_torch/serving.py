"""HTTP serving endpoint of the PyTorch/CUDA pipeline.

Counterpart of ``svc_inference_pipeline_tpu/serving.py``, with the same
classes, flags and HTTP surface, plus ``--device`` (default cuda):

    python -m svc_inference_pipeline_tpu_torch.serving --port 8787 \
        [--random-weights --whisper-size medium]

    POST /convert?singer=svcc_CDF1[&sampler=dpmpp&speedup=10]
                                     (body: WAV bytes) → WAV bytes
    GET  /healthz                    → {"status": "ok", ...}
    GET  /singers                    → name → id map
    GET  /metrics                    → observability JSON

Concurrent requests COALESCE: a worker thread gathers requests for up to
``coalesce_ms`` (max ``max_batch``) and converts them in one
``SVCPipeline.convert_batch`` call — one batched whisper encode, one
batched sampler loop, one batched vocoder pass — so throughput under load
scales with the device batch instead of queueing sequential conversions.
``?stream=1&chunk_seconds=`` answers with chunked raw PCM16 instead
(``pipeline/streaming.py``), each chunk converted under the same device
lock as the batches. The models load from the checkpoint files that
``--config`` names (``SVCPipeline.from_config``); ``--random-weights`` draws
them at random instead.
"""

from __future__ import annotations

import argparse
import json
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np


#: client-selectable fast-sampler strides
ALLOWED_SPEEDUPS = frozenset({1, 2, 5, 10, 20, 50, 100})


class ServerOverloaded(RuntimeError):
    """Request shed: the queue (or stream slots) is at capacity.

    Mapped to HTTP 503 + Retry-After by the handler — under sustained
    overload the server sheds instead of piling requests up against the
    600 s request timeout."""


class _Request:
    __slots__ = ("audio", "singer", "sampler", "speedup", "frames",
                 "event", "result", "error")

    def __init__(self, audio, singer, sampler=None, speedup=None, frames=0):
        self.audio = audio
        self.singer = singer
        self.sampler = sampler  # per-request override (None = server default)
        self.speedup = speedup
        self.frames = frames  # mel frame count → coalescing length class
        self.event = threading.Event()
        self.result = None
        self.error = None


#: shortest coalescing length class, in mel frames (~2.7 s @ hop 256/24 kHz)
MIN_LENGTH_CLASS = 256


def length_class(frames: int) -> int:
    """Coalescing length class: next power of two ≥ the clip's frame count.

    ``convert_batch`` pads every clip in a device batch to the longest
    member's bucket (pipeline/convert.py), so coalescing a 30 s request
    with 3 s requests would inflate the short ones' denoiser/vocoder FLOPs
    ~10×. Grouping by power-of-two class bounds that inflation at 2×
    while still letting similar-length requests share a batch."""
    c = MIN_LENGTH_CLASS
    while c < frames:
        c *= 2
    return c


class SVCServer:
    #: upper bound a request waits for its result before failing the HTTP
    #: call — a belt against any path that could strand the completion event
    REQUEST_TIMEOUT_S = 600.0

    #: grace window for queued work after close() before it is failed
    DRAIN_DEADLINE_S = 30.0

    def __init__(self, pipeline, cfg, coalesce_ms: float = 25.0, max_batch: int = 8,
                 max_queue: int = 32, max_streams: int = 4):
        self.pipeline = pipeline
        self.cfg = cfg
        self.started = time.time()
        self.conversions = 0
        self.batches = 0
        self.batch_failures = 0
        self.sheds = 0
        self.coalesce_ms = coalesce_ms
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.max_streams = max_streams
        self._streams = 0
        self.closed = False
        self._drain_deadline = None
        # one device job at a time: the coalescing worker and every streaming
        # handler thread contend for the device through this lock
        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # BOUNDED: at capacity, convert_bytes sheds with 503 instead of
        # queueing another 10-minute wait nobody will collect
        self.queue: "queue.Queue[Optional[_Request]]" = queue.Queue(maxsize=max_queue)
        self.worker = threading.Thread(target=self._worker, daemon=True)
        self.worker.start()

    def _count(self, conversions: int = 0, batches: int = 0,
               batch_failures: int = 0, sheds: int = 0) -> None:
        with self._stats_lock:
            self.conversions += conversions
            self.batches += batches
            self.batch_failures += batch_failures
            self.sheds += sheds

    # -- coalescing worker -------------------------------------------------

    def _worker(self) -> None:
        while True:
            req = self.queue.get()
            if req is None:
                self._drain()
                return
            batch = [req]
            deadline = time.time() + self.coalesce_ms / 1000.0
            stop = False
            while len(batch) < self.max_batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            self._run(batch)
            if stop:
                self._drain()
                return

    def _drain(self) -> None:
        """Shutdown drain: requests already queued when close() landed
        still get converted while the drain deadline holds; past it,
        the rest fail fast (never strand a waiter: each gets its error
        set and its event fired)."""
        deadline = self._drain_deadline or time.time()
        while True:
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                return
            if req is None:
                continue
            if time.time() < deadline:
                self._run([req])
            else:
                req.error = RuntimeError("server closed")
                req.event.set()

    def _run(self, batch) -> None:
        # a coalesced batch can mix per-request sampler overrides and clip
        # lengths: group by the RESOLVED (sampler, speedup) — explicit
        # defaults coalesce with unspecified ones — plus the power-of-two
        # LENGTH class (one long request must not inflate a batch of short
        # ones to its padded bucket), and convert each group in one device
        # batch
        groups: dict = {}
        for r in batch:
            sampler, speedup = self.pipeline._resolve_sampler(r.sampler, r.speedup)
            key = (sampler, speedup, length_class(r.frames))
            groups.setdefault(key, []).append(r)
        for (sampler, speedup, _), group in groups.items():
            self._run_group(group, sampler, speedup)

    def _run_group(self, batch, sampler, speedup) -> None:
        from svc_inference_pipeline_tpu_torch.utils.observability import get_logger

        try:
            with self._device_lock:
                waves = self.pipeline.convert_batch(
                    [r.audio for r in batch], [r.singer for r in batch],
                    sampler=sampler, speedup=speedup,
                )
            for r, w in zip(batch, waves):
                r.result = w
            self._count(conversions=len(batch), batches=1)
        except Exception as e:  # noqa: BLE001 — isolate failures per request
            # the batch error is the root cause: log it loudly before any
            # fallback (a silent serial retry turns a systemic failure into
            # N slow mysteries)
            get_logger("svc_tpu.serving").exception(
                "convert_batch failed for %d request(s): %s: %s",
                len(batch), type(e).__name__, e,
            )
            self._count(batch_failures=1)
            if len(batch) == 1:
                batch[0].error = e  # nothing to isolate — fail fast
            else:
                # bounded fallback: each request is retried exactly ONCE,
                # individually, so one poison request fails alone while the
                # rest of its batch still completes
                for r in batch:
                    try:
                        with self._device_lock:
                            r.result = self.pipeline.convert(
                                np.asarray(r.audio), r.singer,
                                sampler=sampler, speedup=speedup,
                            )
                        self._count(conversions=1)
                    except Exception as e2:  # noqa: BLE001
                        r.error = e2
        finally:
            for r in batch:
                r.event.set()

    def close(self, drain_s: Optional[float] = None) -> None:
        self.closed = True
        self._drain_deadline = time.time() + (
            self.DRAIN_DEADLINE_S if drain_s is None else drain_s
        )
        self.queue.put(None)

    # -- request entry -----------------------------------------------------

    def convert_bytes(self, wav_bytes: bytes, singer: str,
                      sampler: Optional[str] = None,
                      speedup: Optional[int] = None) -> bytes:
        from svc_inference_pipeline_tpu_torch.utils.audio_io import load_audio, save_audio
        from svc_inference_pipeline_tpu_torch.utils.registry import get_singer_id

        get_singer_id(self.cfg, singer)  # KeyError → 400 before enqueue
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(wav_bytes)
            f.flush()
            audio, _ = load_audio(f.name, self.cfg.fs)

        if self.closed:
            raise RuntimeError("server closed")
        audio = np.asarray(audio)
        frames = self.pipeline.mel_frame_count(len(audio))
        if frames < 1:
            raise ValueError(  # client error → 400, like an unknown singer
                f"clip too short: {len(audio)} samples is less than one mel "
                f"hop ({self.cfg.hop_length} samples)"
            )
        req = _Request(audio, singer, sampler=sampler, speedup=speedup,
                       frames=frames)
        try:
            self.queue.put_nowait(req)
        except queue.Full:
            self._count(sheds=1)
            raise ServerOverloaded(
                f"queue at capacity ({self.max_queue} pending) — retry later"
            ) from None
        # close() may have landed between the check and the put — the worker
        # could already have drained and exited, stranding req until the
        # 600 s timeout. Re-check and fail fast (event.set is idempotent, so
        # racing with a concurrent _drain is harmless).
        if self.closed and not req.event.is_set():
            req.error = RuntimeError("server closed")
            req.event.set()
        if not req.event.wait(timeout=self.REQUEST_TIMEOUT_S):
            raise TimeoutError(
                f"conversion not completed within {self.REQUEST_TIMEOUT_S:.0f}s"
            )
        if req.error is not None:
            raise req.error
        with tempfile.NamedTemporaryFile(suffix=".wav") as out:
            save_audio(out.name, req.result, self.cfg.fs)
            out.seek(0)
            return open(out.name, "rb").read()

    def convert_stream_pcm(self, wav_bytes: bytes, singer: str,
                           chunk_seconds: float = 10.0,
                           sampler: Optional[str] = None,
                           speedup: Optional[int] = None):
        """Generator of raw PCM16 byte chunks (pipeline/streaming.py).

        Bypasses the coalescing *queue* but not the device: each chunk's
        conversion runs under the shared device lock, so streams interleave
        with batch work chunk by chunk instead of contending for the device.
        Every chunk pads to the same bucket."""
        from svc_inference_pipeline_tpu_torch.utils.audio_io import load_audio
        from svc_inference_pipeline_tpu_torch.utils.registry import get_singer_id

        get_singer_id(self.cfg, singer)  # KeyError → 400 before streaming
        with self._stats_lock:
            if self._streams >= self.max_streams:
                self.sheds += 1
                raise ServerOverloaded(
                    f"{self.max_streams} concurrent streams already open — "
                    "retry later"
                )
            self._streams += 1
        try:
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                f.write(wav_bytes)
                f.flush()
                audio, _ = load_audio(f.name, self.cfg.fs)

            if self.pipeline.mel_frame_count(len(np.asarray(audio))) < 1:
                raise ValueError(
                    f"clip too short: {len(np.asarray(audio))} samples is "
                    f"less than one mel hop ({self.cfg.hop_length} samples)"
                )
            gen = self.pipeline.convert_streaming(
                np.asarray(audio), singer, chunk_seconds=chunk_seconds,
                sampler=sampler, speedup=speedup,
            )
            while True:
                # the device work happens lazily inside next(): hold the lock
                # only for the duration of one chunk, then yield it to the
                # client while other work can take the device
                with self._device_lock:
                    try:
                        piece = next(gen)
                    except StopIteration:
                        return
                self._count(conversions=1)
                pcm = np.clip(np.round(np.asarray(piece) * 32767.0), -32768, 32767)
                yield pcm.astype("<i2").tobytes()
        finally:
            with self._stats_lock:
                self._streams -= 1

    def handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer framing (the streaming endpoint) is only
            # defined for HTTP/1.1; every non-chunked response carries
            # Content-Length, so keep-alive is safe
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through our logger
                from svc_inference_pipeline_tpu_torch.utils.observability import get_logger

                get_logger("svc_tpu.serving").info(fmt, *args)

            def _json(self, code: int, obj, retry_after: Optional[int] = None) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._json(200, {
                        "status": "ok",
                        "uptime_s": round(time.time() - server.started, 1),
                        "conversions": server.conversions,
                    })
                elif path == "/singers":
                    from svc_inference_pipeline_tpu_torch.utils.registry import load_singer_lut

                    self._json(200, load_singer_lut(server.cfg.singer_file))
                elif path == "/metrics":
                    from svc_inference_pipeline_tpu_torch.utils.observability import Metrics

                    m = Metrics.default().summary()
                    m["serving"] = {
                        "conversions": server.conversions,
                        "batches": server.batches,
                        "batch_failures": server.batch_failures,
                        "mean_batch": (
                            server.conversions / server.batches
                            if server.batches else 0.0
                        ),
                        "queue_depth": server.queue.qsize(),
                        "max_queue": server.max_queue,
                        "sheds": server.sheds,
                        "streams": server._streams,
                    }
                    self._json(200, m)
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                parsed = urlparse(self.path)
                if parsed.path != "/convert":
                    self._json(404, {"error": "not found"})
                    return
                query = parse_qs(parsed.query)
                singer = query.get("singer", [None])[0]
                if not singer:
                    self._json(400, {"error": "missing ?singer="})
                    return
                sampler = query.get("sampler", [None])[0]
                if sampler is not None and sampler not in ("ddpm", "plms", "ddim", "dpmpp"):
                    self._json(400, {"error": f"unknown sampler {sampler!r}"})
                    return
                speedup = None
                if query.get("speedup"):
                    try:
                        speedup = int(query["speedup"][0])
                    except ValueError:
                        speedup = -1
                    # allowlist: an open-ended stride would let one client
                    # pick the cost of every batch it lands in
                    if speedup not in ALLOWED_SPEEDUPS:
                        self._json(400, {"error":
                            f"speedup must be one of {sorted(ALLOWED_SPEEDUPS)}"})
                        return
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._json(400, {"error": "empty body (expected WAV bytes)"})
                    return
                body = self.rfile.read(length)
                if query.get("stream", ["0"])[0] in ("1", "true"):
                    # chunked raw PCM16 @ cfg.fs: each converted chunk is
                    # flushed as soon as the pipeline yields it — time to
                    # first audio is O(chunk), not O(clip)
                    try:
                        chunk_s = float(query.get("chunk_seconds", ["10"])[0])
                        gen = server.convert_stream_pcm(body, singer, chunk_s,
                                                        sampler=sampler,
                                                        speedup=speedup)
                        first = next(gen)  # raise before headers if broken
                    except (KeyError, ValueError) as e:
                        self._json(400, {"error": str(e)})
                        return
                    except ServerOverloaded as e:
                        self._json(503, {"error": str(e)}, retry_after=5)
                        return
                    except Exception as e:  # noqa: BLE001
                        self._json(500, {"error": f"{type(e).__name__}: {e}"})
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/L16")
                    self.send_header("X-Sample-Rate", str(server.cfg.fs))
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def emit(data: bytes) -> None:
                        self.wfile.write(f"{len(data):X}\r\n".encode())
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")

                    try:
                        emit(first)
                        for piece in gen:
                            emit(piece)
                        self.wfile.write(b"0\r\n\r\n")
                    except (ConnectionError, BrokenPipeError):
                        pass  # client went away mid-stream — just stop
                    return
                try:
                    out = server.convert_bytes(body, singer, sampler=sampler,
                                               speedup=speedup)
                except (KeyError, ValueError) as e:
                    self._json(400, {"error": str(e)})
                    return
                except ServerOverloaded as e:
                    self._json(503, {"error": str(e)}, retry_after=5)
                    return
                except Exception as e:  # noqa: BLE001 — surface to client
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        return Handler


def serve(cfg, pipeline, host: str = "127.0.0.1", port: int = 8787,
          coalesce_ms: float = 25.0, max_batch: int = 8,
          max_queue: int = 32, max_streams: int = 4) -> ThreadingHTTPServer:
    server = SVCServer(pipeline, cfg, coalesce_ms=coalesce_ms, max_batch=max_batch,
                       max_queue=max_queue, max_streams=max_streams)
    httpd = ThreadingHTTPServer((host, port), server.handler_class())
    httpd.svc = server  # for tests
    return httpd


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="svc-serve")
    p.add_argument("--config", default="./config/config.json")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--random-weights", action="store_true",
                   help="random-init models (no checkpoints needed)")
    p.add_argument("--whisper-size", default="tiny")
    p.add_argument("--sampler", choices=["ddpm", "plms", "ddim", "dpmpp"],
                   default=None, help="override cfg.mapper.sampler")
    p.add_argument("--speedup", type=int, default=None, help="fast-sampler stride")
    p.add_argument("--quantize", choices=["int8", "int8-w1"], default=None,
                   help="int8 denoiser matmuls (int8-w1 keeps the output "
                        "projection at the compute dtype)")
    p.add_argument("--max-queue", type=int, default=32,
                   help="pending-request cap; beyond it requests shed with 503")
    p.add_argument("--max-streams", type=int, default=4,
                   help="concurrent streaming-response cap (503 beyond)")
    p.add_argument("--device", default="cuda", help="cuda (also: tpu, gpu) or cpu")
    args = p.parse_args(argv)

    from svc_inference_pipeline_tpu_torch.config import load_config
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    cfg = load_config(args.config)
    if args.quantize:
        cfg.denoiser_quantize = args.quantize
    pipeline = SVCPipeline.from_config(
        cfg, random_weights=args.random_weights, whisper_size=args.whisper_size, device=args.device
    )
    if args.sampler or args.speedup is not None:
        pipeline.set_sampler(args.sampler or pipeline.sampler, speedup=args.speedup)
    httpd = serve(cfg, pipeline, args.host, args.port,
                  max_queue=args.max_queue, max_streams=args.max_streams)
    print(f"serving on {args.host}:{httpd.server_address[1]} ({pipeline.device})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        httpd.svc.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
