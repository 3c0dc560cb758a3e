"""The port's server (``svc_inference_pipeline_tpu_torch/serving.py``): the
coalescing worker, its grouping and failure isolation, overload shedding
and drain on a stand-in pipeline (no device work); the HTTP surface on that
stand-in and on a tiny port pipeline on CPU, against the JAX server's
constants and ``/metrics`` keys."""

import contextlib
import http.client
import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu import serving as jax_serving
from svc_inference_pipeline_tpu.utils.registry import load_singer_lut as jax_singer_lut
from svc_inference_pipeline_tpu_torch import serving
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline, mel_frame_count
from svc_inference_pipeline_tpu_torch.serving import ServerOverloaded, SVCServer, _Request
from svc_inference_pipeline_tpu_torch.utils.audio_io import read_wav, write_wav

SINGER = "svcc_CDF1"
POISON = 4321  # a clip of this many samples fails to convert


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pcfg(cfg):
    return HParams(**cfg.to_dict())


class StubPipe:
    """Pipeline stand-in: conversions take ``batch_s`` seconds, return a
    constant waveform of the clip's length, and fail for a POISON-long clip.
    It records every call."""

    def __init__(self, cfg, batch_s=0.0):
        self.cfg = cfg
        self.batch_s = batch_s
        self.batches, self.singles = [], []

    def _resolve_sampler(self, sampler, speedup):
        sampler = sampler or "ddpm"
        return sampler, 1 if sampler == "ddpm" else speedup or 10

    def mel_frame_count(self, n_samples):
        return mel_frame_count(self.cfg, n_samples)

    def convert_batch(self, wavs, singers, sampler=None, speedup=None):
        time.sleep(self.batch_s)
        self.batches.append((sorted(len(w) for w in wavs), sampler, speedup))
        if any(len(w) == POISON for w in wavs):
            raise RuntimeError("poisoned batch")
        return [np.full(len(w), 0.25, np.float32) for w in wavs]

    def convert(self, wav, singer, sampler=None, speedup=None):
        time.sleep(self.batch_s)
        self.singles.append(len(wav))
        if len(wav) == POISON:
            raise RuntimeError("poisoned clip")
        return np.full(len(wav), 0.25, np.float32)


def _wav_bytes(n_samples, fs=24000):
    t = np.arange(n_samples) / fs
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        write_wav(f.name, 0.4 * np.sin(2 * np.pi * 220.0 * t), fs)
    with open(f.name, "rb") as f2:
        data = f2.read()
    os.unlink(f.name)
    return data


def _wav_samples(data):
    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(data)
        f.flush()
        samples, sr = read_wav(f.name)
    return samples[:, 0], sr


@contextlib.contextmanager
def _closing(server):
    try:
        yield server
    finally:
        server.close(drain_s=0.0)
        server.worker.join(timeout=10)
        assert not server.worker.is_alive()


def test_length_class_and_speedups_match_jax():
    assert serving.ALLOWED_SPEEDUPS == jax_serving.ALLOWED_SPEEDUPS
    assert serving.MIN_LENGTH_CLASS == jax_serving.MIN_LENGTH_CLASS
    for frames in list(range(0, 5000, 7)) + [2 ** k + d for k in range(16) for d in (-1, 0, 1)]:
        assert serving.length_class(frames) == jax_serving.length_class(frames), frames


def test_burst_coalesces_by_sampler_and_length_class(pcfg):
    """Four concurrent requests: two short ones with the default sampler
    share one batch; a long one (another length class) and a short one with
    an explicit sampler get batches of their own."""
    pipe = StubPipe(pcfg)
    short, long_ = 24000, 12 * 24000  # 94 frames (class 256), 1126 frames (class 2048)
    jobs = [(short, None, None), (short, None, None), (long_, None, None), (short, "plms", 10)]
    with _closing(SVCServer(pipe, pcfg, coalesce_ms=1500.0, max_batch=8)) as server:
        out = [None] * len(jobs)

        def work(i, n, sampler, speedup):
            out[i] = server.convert_bytes(_wav_bytes(n), SINGER, sampler=sampler, speedup=speedup)

        threads = [threading.Thread(target=work, args=(i, *job)) for i, job in enumerate(jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert sorted(pipe.batches, key=str) == sorted(
            [([short, short], "ddpm", 1), ([long_], "ddpm", 1), ([short], "plms", 10)], key=str)
        assert (server.batches, server.conversions, server.batch_failures) == (3, 4, 0)
        for data, (n, _, _) in zip(out, jobs):
            samples, sr = _wav_samples(data)
            assert sr == 24000 and len(samples) == n + 2 * 1200


def test_poison_request_fails_alone_and_a_single_one_fails_fast(pcfg):
    pipe = StubPipe(pcfg)
    with _closing(SVCServer(pipe, pcfg, coalesce_ms=1.0)) as server:
        reqs = [_Request(np.zeros(n, np.float32), SINGER) for n in (2400, POISON, 4800)]
        server._run_group(reqs, "ddpm", 1)
        assert [r.event.is_set() for r in reqs] == [True] * 3
        assert reqs[0].error is None and len(reqs[0].result) == 2400
        assert reqs[2].error is None and len(reqs[2].result) == 4800
        assert isinstance(reqs[1].error, RuntimeError) and reqs[1].result is None
        assert pipe.singles == [2400, POISON, 4800]  # each retried exactly once
        assert (server.batch_failures, server.conversions, server.batches) == (1, 2, 0)

        alone = _Request(np.zeros(POISON, np.float32), SINGER)
        server._run_group([alone], "ddpm", 1)
        assert isinstance(alone.error, RuntimeError) and alone.event.is_set()
        assert pipe.singles == [2400, POISON, 4800]  # nothing to isolate: no retry
        assert server.batch_failures == 2


def test_closed_server_rejects_and_drains_until_its_deadline(pcfg):
    pipe = StubPipe(pcfg, batch_s=0.05)
    server = SVCServer(pipe, pcfg, coalesce_ms=1.0, max_batch=1, max_queue=8)
    server._drain_deadline = time.time() + 30.0
    lucky = _Request(np.zeros(2400, np.float32), SINGER)
    server.queue.put(lucky)
    server._drain()
    assert lucky.event.is_set() and lucky.error is None and lucky.result is not None

    server._drain_deadline = time.time() - 1.0
    stranded = _Request(np.zeros(2400, np.float32), SINGER)
    server.queue.put(stranded)
    server._drain()
    assert stranded.event.is_set() and isinstance(stranded.error, RuntimeError)

    server.close(drain_s=0.0)
    server.worker.join(timeout=10)
    assert not server.worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        server.convert_bytes(_wav_bytes(2400), SINGER)


def test_flood_sheds_instead_of_piling_up(pcfg):
    """Queue bounded at 2, a slow worker, ten concurrent requests: every one
    completes or sheds, at least one of each."""
    pipe = StubPipe(pcfg, batch_s=0.3)
    payload = _wav_bytes(4800)
    outcomes = [None] * 10
    with _closing(SVCServer(pipe, pcfg, coalesce_ms=1.0, max_batch=1, max_queue=2)) as server:
        def work(i):
            try:
                outcomes[i] = ("ok", server.convert_bytes(payload, SINGER))
            except ServerOverloaded as e:
                outcomes[i] = ("shed", e)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(outcomes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        kinds = [o[0] for o in outcomes if o is not None]
        assert len(kinds) == len(outcomes)
        assert kinds.count("shed") >= 1 and kinds.count("ok") >= 1
        assert server.sheds == kinds.count("shed")


def test_stream_slot_cap_sheds(pcfg):
    with _closing(SVCServer(StubPipe(pcfg), pcfg, coalesce_ms=1.0, max_streams=1)) as server:
        server._streams = server.max_streams  # one stream already open
        with pytest.raises(ServerOverloaded):
            next(server.convert_stream_pcm(_wav_bytes(4800), SINGER))
        assert server.sheds == 1 and server._streams == server.max_streams
        server._streams = 0


@contextlib.contextmanager
def _serving(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.svc.close(drain_s=0.0)
        thread.join(timeout=10)
        httpd.svc.worker.join(timeout=10)
        assert not thread.is_alive() and not httpd.svc.worker.is_alive()


def _request(url, body=None):
    """(status, headers, body bytes) of a GET, or of a POST with ``body``,
    to the server at ``url`` (http://127.0.0.1:<port>/...), with no proxy."""
    host_port, path = url.removeprefix("http://").split("/", 1)
    host, port = host_port.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("GET" if body is None else "POST", "/" + path, body=body)
        r = conn.getresponse()
        return r.status, r.headers, r.read()
    finally:
        conn.close()


def test_http_errors_on_a_stub_pipeline(pcfg):
    httpd = serving.serve(pcfg, StubPipe(pcfg), "127.0.0.1", 0, coalesce_ms=1.0)
    good = _wav_bytes(4800)
    with _serving(httpd) as base:
        for query, body in (("", good), ("?singer=nobody", good), (f"?singer={SINGER}&sampler=euler", good),
                            (f"?singer={SINGER}&speedup=7", good), (f"?singer={SINGER}&speedup=x", good),
                            (f"?singer={SINGER}", _wav_bytes(100)), (f"?singer={SINGER}", b""),
                            (f"?singer={SINGER}&stream=1", _wav_bytes(100))):
            status, _, data = _request(base + "/convert" + query, body)
            assert status == 400, (query, status, data)
        assert _request(base + "/nowhere")[0] == 404

        def overloaded(*a, **kw):
            raise ServerOverloaded("full")

        httpd.svc.convert_bytes = overloaded
        status, headers, _ = _request(f"{base}/convert?singer={SINGER}", good)
        assert status == 503 and headers["Retry-After"] == "5"

        def broken(*a, **kw):
            raise RuntimeError("device lost")

        httpd.svc.convert_bytes = broken
        status, _, data = _request(f"{base}/convert?singer={SINGER}", good)
        assert status == 500 and b"device lost" in data


def test_http_surface_on_a_tiny_pipeline(cfg, pcfg):
    d = pcfg.to_dict()
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=2, residual_channels=64)
    d["vocoder"]["upsample_initial_channel"] = 64
    pipe = SVCPipeline.from_config(HParams(**d), random_weights=True, device="cpu")
    jax_httpd = jax_serving.serve(cfg, StubPipe(pcfg), "127.0.0.1", 0, coalesce_ms=1.0)
    with _serving(jax_httpd) as jax_base:
        jax_metrics = json.loads(_request(jax_base + "/metrics")[2])
    httpd = serving.serve(pipe.cfg, pipe, "127.0.0.1", 0, coalesce_ms=1.0)
    with _serving(httpd) as base:
        status, _, data = _request(base + "/healthz")
        assert status == 200 and json.loads(data)["status"] == "ok"
        status, _, data = _request(base + "/singers")
        assert status == 200 and json.loads(data) == jax_singer_lut(cfg.singer_file)

        n = 24000
        status, headers, data = _request(f"{base}/convert?singer={SINGER}&sampler=plms&speedup=2",
                                         _wav_bytes(n))
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        samples, sr = _wav_samples(data)
        assert sr == 24000 and len(samples) == mel_frame_count(pipe.cfg, n) * 256 + 2 * 1200

        n = 72000
        status, headers, data = _request(f"{base}/convert?singer={SINGER}&stream=1&chunk_seconds=1",
                                         _wav_bytes(n))
        assert status == 200 and headers["Content-Type"] == "audio/L16" and headers["X-Sample-Rate"] == "24000"
        pcm = np.frombuffer(data, "<i2")
        assert len(pcm) == n and np.abs(pcm).max() > 0

        status, _, data = _request(base + "/metrics")
        metrics = json.loads(data)
        assert status == 200 and set(metrics["serving"]) == set(jax_metrics["serving"])
        assert metrics["serving"]["conversions"] == 1 + 3 and metrics["serving"]["batches"] == 1
