"""The port's fault injection and gang-restart supervisor
(``training/elastic.py``), held to the JAX package's drills
(``tests/test_elastic.py``): the spec grammar and scoping, stub-worker
gangs that crash, hang or never beat, the restart budget, the port's
``train_diffusion`` resuming from its checkpoint after a crash, and a real
gang of two processes joined by ``distributed.ensure_initialized`` (gloo
over TCP on 127.0.0.1) that a kill breaks and the supervisor restarts; and
the two-process rendezvous of ``tests/test_multihost.py``. All with real
OS processes."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

from svc_inference_pipeline_tpu_torch.training.elastic import (
    ElasticFailure,
    FaultInjector,
    InjectedFault,
    _reset_injector_for_tests,
    fault_hook,
    run_elastic,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A stale heartbeat after this many seconds is a hang. The JAX drill's 1.5 s
# failed under a loaded test run once (a stub that merely slept past it);
# the stub beats every 0.05 s, so 8 s is a wide margin.
HEARTBEAT_TIMEOUT = 8.0
# A worker without a first beat after this many seconds is a hang. The stub
# imports torch before its first beat: 7.9 s in a loaded six-worker run, and
# over the JAX drill's 10 s in the restarted attempt of that run.
STARTUP_GRACE = 30.0


# ---------------------------------------------------------------- injector

def test_fault_spec_parsing():
    faults = FaultInjector.parse("die@5:a0, nan@3:p1, hang@7:p0:a2")
    assert [(f.action, f.step, f.process_id, f.attempt) for f in faults] == [
        ("die", 5, None, 0), ("nan", 3, 1, None), ("hang", 7, 0, 2)]
    with pytest.raises(ValueError):
        FaultInjector.parse("explode@5")
    with pytest.raises(ValueError):
        FaultInjector.parse("die@x")
    with pytest.raises(ValueError):
        FaultInjector.parse("die@5:z9")


def test_fault_scoping(monkeypatch):
    inj = FaultInjector(FaultInjector.parse("exc@4:p1:a1"))
    monkeypatch.setenv("SVC_PROCESS_ID", "1")
    monkeypatch.setenv("SVC_ELASTIC_ATTEMPT", "0")
    assert inj.action_for(4) is None          # wrong attempt
    monkeypatch.setenv("SVC_ELASTIC_ATTEMPT", "1")
    assert inj.action_for(4) == "exc"
    assert inj.action_for(3) is None          # wrong step
    monkeypatch.setenv("SVC_PROCESS_ID", "0")
    assert inj.action_for(4) is None          # wrong process
    monkeypatch.setenv("SVC_PROCESS_ID", "1")
    with pytest.raises(InjectedFault):
        inj.fire(4)


def test_fault_hook_unset_is_noop(monkeypatch):
    monkeypatch.delenv("SVC_FAULT_INJECT", raising=False)
    _reset_injector_for_tests()
    assert fault_hook(0) is None
    _reset_injector_for_tests()


def test_fault_hook_returns_nan(monkeypatch):
    monkeypatch.setenv("SVC_FAULT_INJECT", "nan@2")
    _reset_injector_for_tests()
    try:
        assert [fault_hook(s) for s in range(4)] == [None, None, "nan", None]
    finally:
        _reset_injector_for_tests()


# ------------------------------------------------------- stub-worker gangs

# A worker with a checkpointed step counter in a file and the fault hook and
# heartbeat each step: the supervisor's semantics alone.
_STUB = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, {repo!r})
    from svc_inference_pipeline_tpu_torch.training.elastic import fault_hook, heartbeat
    state = sys.argv[1] + ".w" + os.environ.get("SVC_PROCESS_ID", "0")
    start = int(open(state).read()) if os.path.exists(state) else 0
    for step in range(start, 8):
        fault_hook(step)
        heartbeat(step)
        with open(state, "w") as f:
            f.write(str(step + 1))
        time.sleep(0.05)
""").format(repo=REPO)


def _stub_argv(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_STUB)
    return [sys.executable, str(script), str(tmp_path / "state")]


def test_supervisor_clean_completion(tmp_path):
    res = run_elastic(_stub_argv(tmp_path), num_workers=1, max_restarts=1)
    assert res.restarts == 0
    assert (tmp_path / "state.w0").read_text() == "8"


def test_supervisor_restarts_crashed_gang(tmp_path):
    # worker 1 of 2 dies at step 5 on attempt 0 only; the supervisor tears
    # down the healthy worker 0 too, relaunches, and both resume from their
    # file checkpoints and finish
    res = run_elastic(
        _stub_argv(tmp_path), num_workers=2, max_restarts=2,
        extra_env={"SVC_FAULT_INJECT": "die@5:p1:a0"},
        poll_interval=0.05,
    )
    assert res.restarts == 1
    assert res.attempts[0]["failure"] is not None
    assert 13 in res.attempts[0]["exit_codes"]
    assert res.attempts[1]["failure"] is None
    assert (tmp_path / "state.w0").read_text() == "8"
    assert (tmp_path / "state.w1").read_text() == "8"


def test_supervisor_detects_hang_via_heartbeat(tmp_path):
    res = run_elastic(
        _stub_argv(tmp_path), num_workers=1, max_restarts=1,
        heartbeat_timeout=HEARTBEAT_TIMEOUT, heartbeat_dir=str(tmp_path / "hb"),
        extra_env={"SVC_FAULT_INJECT": "hang@4:a0"},
        poll_interval=0.05, grace_period=1.0,
    )
    assert res.restarts == 1
    assert "heartbeat stale" in res.attempts[0]["failure"]
    assert (tmp_path / "state.w0").read_text() == "8"


def test_supervisor_startup_grace(tmp_path):
    # a hang BEFORE the first beat is invisible to the staleness clock (it
    # starts at the first beat); startup_grace catches it
    res = run_elastic(
        _stub_argv(tmp_path), num_workers=1, max_restarts=1,
        heartbeat_timeout=30.0, startup_grace=STARTUP_GRACE,
        heartbeat_dir=str(tmp_path / "hb"),
        extra_env={"SVC_FAULT_INJECT": "hang@0:a0"},
        poll_interval=0.05, grace_period=1.0,
    )
    assert res.restarts == 1
    assert "no first heartbeat" in res.attempts[0]["failure"]
    assert (tmp_path / "state.w0").read_text() == "8"


def test_supervisor_restart_budget_exhausted(tmp_path):
    with pytest.raises(ElasticFailure) as ei:
        run_elastic(
            _stub_argv(tmp_path), num_workers=1, max_restarts=1,
            extra_env={"SVC_FAULT_INJECT": "die@5"},  # every attempt
            poll_interval=0.05,
        )
    assert len(ei.value.result.attempts) == 2
    assert all(a["failure"] for a in ei.value.result.attempts)


def test_supervisor_hands_out_the_rendezvous_env(tmp_path):
    script = tmp_path / "env_worker.py"
    script.write_text(textwrap.dedent("""
        import os, sys
        keys = ("SVC_PROCESS_ID", "SVC_NUM_PROCESSES", "SVC_COORDINATOR", "SVC_ELASTIC_ATTEMPT")
        with open(sys.argv[1] + os.environ["SVC_PROCESS_ID"], "w") as f:
            f.write(" ".join(os.environ.get(k, "-") for k in keys))
    """))
    res = run_elastic([sys.executable, str(script), str(tmp_path / "env")], num_workers=2, max_restarts=0)
    assert res.restarts == 0
    got = [(tmp_path / f"env{i}").read_text().split() for i in range(2)]
    assert [g[0] for g in got] == ["0", "1"] and all(g[1] == "2" and g[3] == "0" for g in got)
    assert got[0][2] == got[1][2] and got[0][2].startswith("127.0.0.1:")


# ------------------------------------------- real training-loop integration

# One-worker gang running the port's train_diffusion on the tiny config on
# the CPU: dies at step 5 (attempt 0), restarts, resumes from the step-4
# checkpoint and completes 8 steps.
_TRAIN_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from svc_inference_pipeline_tpu_torch.config import HParams, load_config
    from svc_inference_pipeline_tpu_torch.training.loop import train_diffusion

    d = load_config({config!r}).to_dict()
    d["mapper"]["residual_layer_num"] = 2
    d["mapper"]["noise_schedule_factors"] = [0.0001, 0.02, 10]
    d["mapper"]["input_content_dim"] = {{"whisper": 16}}
    d["mapper"]["content_feature"] = ["whisper"]
    cfg = HParams(**d)

    rng = np.random.default_rng(0)
    loader = [{{
        "mel": rng.standard_normal((2, 32, 100)).astype(np.float32) * 0.1,
        "content_whisper": rng.standard_normal((2, 32, 16)).astype(np.float32),
        "melody": np.abs(rng.uniform(0, 500, (2, 32))).astype(np.float32),
        "loudness": np.abs(rng.uniform(0, 1, (2, 32))).astype(np.float32),
        "singer": np.zeros((2, 1), dtype=np.int32),
    }} for _ in range(4)]

    state = train_diffusion(cfg, loader, num_steps=8, checkpoint_dir=sys.argv[1], checkpoint_every=2,
                            device="cpu")
    assert state.step == 8, state.step
""").format(repo=REPO, config=os.path.join(REPO, "config", "config.json"))


def test_elastic_training_resumes_from_checkpoint(tmp_path):
    script = tmp_path / "train_worker.py"
    script.write_text(_TRAIN_WORKER)
    ckpt_dir = tmp_path / "ckpts"
    res = run_elastic(
        [sys.executable, str(script), str(ckpt_dir)],
        num_workers=1, max_restarts=1,
        extra_env={"SVC_FAULT_INJECT": "die@5:a0"},
        log_dir=str(tmp_path / "logs"),
    )
    assert res.restarts == 1
    assert 13 in res.attempts[0]["exit_codes"]
    assert res.attempts[1]["exit_codes"] == [0]
    assert (ckpt_dir / "latest").is_file() and not (ckpt_dir / "latest.tmp").exists()
    # the resumed attempt's log shows the checkpoint restore
    log1 = (tmp_path / "logs" / "worker0_a1.log").read_text()
    assert "resumed from step 4" in log1


# ------------------------------------------------ a real distributed gang

# Two processes rendezvous through ensure_initialized (gloo over TCP on
# 127.0.0.1, from the supervisor's SVC_COORDINATOR), all-reduce once per
# step and checkpoint a step counter through process 0. Worker 1 is killed
# at step 5 on attempt 0, leaving worker 0 in the step-5 all-reduce: the
# supervisor reaps it, relaunches both on a fresh port, and they resume at
# step 5 and finish in lockstep (JAX's test_elastic_recovers_real_distributed_gang).
_DIST_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist

    from svc_inference_pipeline_tpu_torch.parallel import distributed
    from svc_inference_pipeline_tpu_torch.training.elastic import fault_hook, heartbeat

    assert distributed.ensure_initialized(device="cpu")
    n = dist.get_world_size()
    pid = dist.get_rank()
    ckpt = sys.argv[1]  # process 0's checkpoint (the step counter)
    start = int(open(ckpt).read()) if os.path.exists(ckpt) else 0
    for step in range(start, 8):
        fault_hook(step)
        heartbeat(step)
        x = torch.full((2,), float(step + 1))
        dist.all_reduce(x)  # the cross-process collective
        assert float(x.sum()) == (step + 1) * n * 2, (float(x.sum()), step)
        if pid == 0:
            with open(ckpt, "w") as f:
                f.write(str(step + 1))
    print("DIST_ELASTIC_OK", pid, flush=True)
    dist.destroy_process_group()
""").format(repo=REPO)


def test_elastic_recovers_real_distributed_gang(tmp_path):
    script = tmp_path / "dist_worker.py"
    script.write_text(_DIST_WORKER)
    res = run_elastic(
        [sys.executable, str(script), str(tmp_path / "ckpt")],
        num_workers=2, max_restarts=1,
        extra_env={"SVC_FAULT_INJECT": "die@5:p1:a0"},
        log_dir=str(tmp_path / "logs"), grace_period=10.0,
    )
    assert res.restarts == 1
    assert 13 in res.attempts[0]["exit_codes"]          # the injected kill
    assert res.attempts[1]["exit_codes"] == [0, 0]
    assert (tmp_path / "ckpt").read_text() == "8"
    for wid in range(2):
        log1 = (tmp_path / "logs" / f"worker{wid}_a1.log").read_text()
        assert f"DIST_ELASTIC_OK {wid}" in log1


# ------------------------------------------------- the bare rendezvous

# tests/test_multihost.py's workers: two processes join one group through
# SVC_COORDINATOR and all-reduce across it. JAX's processes hold 2 virtual
# devices each (4 global); the port has one device a process, so 2.
_RENDEZVOUS_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist

    from svc_inference_pipeline_tpu_torch.parallel import distributed

    assert distributed.is_distributed_env()
    assert distributed.ensure_initialized(device="cpu")
    info = distributed.process_info()
    assert info["process_count"] == 2, info
    assert info["global_devices"] == 2, info  # one device a process
    assert info["backend"] == "gloo" and info["device"] == "cpu", info
    x = torch.arange(3, dtype=torch.float32) + 3 * info["process_index"]
    dist.all_reduce(x)
    assert x.tolist() == [3.0, 5.0, 7.0], x
    print("MULTIHOST_OK", info["process_index"], flush=True)
    dist.destroy_process_group()
""").format(repo=REPO)


def test_two_process_rendezvous_and_all_reduce():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, SVC_COORDINATOR=f"127.0.0.1:{port}", SVC_NUM_PROCESSES="2",
                   SVC_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, "-c", _RENDEZVOUS_WORKER], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=50)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST_OK {pid}" in out, out
