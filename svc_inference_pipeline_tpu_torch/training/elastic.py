"""Elastic multi-process training: fault injection and a gang-restart supervisor.

Counterpart of ``svc_inference_pipeline_tpu/training/elastic.py``, pure
Python (subprocess, files, sockets) with the port's logger:

* **Deterministic fault injection** (:class:`FaultInjector`): an env spec
  such as ``SVC_FAULT_INJECT="die@5:a0"`` makes a worker crash, raise, hang
  or poison its loss at an exact step, optionally only in one process
  (``:pN``) and one incarnation (``:aM``, so a drill fires once instead of
  crash-looping after the restart). The training loop calls
  :func:`fault_hook` every step; with the env unset it costs one check.

* **Gang-restart recovery** (:func:`run_elastic`): a supervisor that
  launches one worker process per host, hands each the rendezvous env
  ``SVC_COORDINATOR``/``SVC_NUM_PROCESSES``/``SVC_PROCESS_ID`` (which
  ``parallel.distributed.ensure_initialized`` reads to join the gang's
  process group over TCP), and watches
  liveness two ways: process exit and a per-worker heartbeat file the
  training loop touches every step (:func:`heartbeat`). When a worker dies
  or its heartbeat goes stale (a hang, which exit monitoring misses), the
  whole gang is torn down and relaunched from the latest checkpoint, up to
  ``max_restarts`` times. Collectives cannot shrink a live gang (a dead
  host wedges the survivors in the next collective), so the unit of
  recovery is the gang restarted from a checkpoint, torchelastic's
  semantics.

Liveness, restarts and fault events are logged through
``utils.observability``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from svc_inference_pipeline_tpu_torch.utils.observability import get_logger

ENV_SPEC = "SVC_FAULT_INJECT"
ENV_ATTEMPT = "SVC_ELASTIC_ATTEMPT"
ENV_HEARTBEAT_DIR = "SVC_HEARTBEAT_DIR"

_EXIT_INJECTED = 13  # distinct from Python's generic 1 so logs name the cause


class InjectedFault(RuntimeError):
    """Raised by the ``exc`` fault action."""


@dataclass(frozen=True)
class _Fault:
    action: str           # die | exc | hang | nan
    step: int             # fire when the training loop reaches this step
    process_id: Optional[int] = None   # only this SVC_PROCESS_ID (None = all)
    attempt: Optional[int] = None      # only this SVC_ELASTIC_ATTEMPT (None = all)


class FaultInjector:
    """Parses and fires ``SVC_FAULT_INJECT`` specs.

    Spec grammar (comma-separated faults)::

        ACTION@STEP[:pN][:aM]

    ``die`` → ``os._exit(13)`` (simulates a host loss: no cleanup, no
    exception propagation); ``exc`` → raise :class:`InjectedFault`;
    ``hang`` → sleep forever (heartbeat goes stale); ``nan`` → the loop
    poisons that step's loss, exercising the non-finite guard live.
    """

    def __init__(self, faults: Sequence[_Fault]):
        self._faults = list(faults)

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "FaultInjector":
        env = os.environ if env is None else env
        spec = env.get(ENV_SPEC, "").strip()
        return cls(cls.parse(spec)) if spec else cls([])

    @staticmethod
    def parse(spec: str) -> List[_Fault]:
        faults = []
        for part in filter(None, (s.strip() for s in spec.split(","))):
            head, *mods = part.split(":")
            action, _, step_s = head.partition("@")
            if action not in ("die", "exc", "hang", "nan") or not step_s.isdigit():
                raise ValueError(
                    f"bad {ENV_SPEC} entry {part!r} — expected "
                    "'die|exc|hang|nan@STEP[:pN][:aM]'"
                )
            pid = att = None
            for m in mods:
                if m.startswith("p") and m[1:].isdigit():
                    pid = int(m[1:])
                elif m.startswith("a") and m[1:].isdigit():
                    att = int(m[1:])
                else:
                    raise ValueError(f"bad {ENV_SPEC} modifier {m!r} in {part!r}")
            faults.append(_Fault(action, int(step_s), pid, att))
        return faults

    def action_for(self, step: int) -> Optional[str]:
        """The action to fire at ``step`` on this process/attempt, if any."""
        if not self._faults:
            return None
        pid = int(os.environ.get("SVC_PROCESS_ID", "0") or "0")
        att = int(os.environ.get(ENV_ATTEMPT, "0") or "0")
        for f in self._faults:
            if (f.step == step
                    and (f.process_id is None or f.process_id == pid)
                    and (f.attempt is None or f.attempt == att)):
                return f.action
        return None

    def fire(self, step: int) -> Optional[str]:
        """Fire any matching fault. Returns "nan" for the loop to handle;
        ``die``/``exc``/``hang`` never return."""
        action = self.action_for(step)
        if action is None or action == "nan":
            return action
        log = get_logger("svc_tpu.elastic")
        log.warning("fault injection: %s at step %d (pid %d)", action, step, os.getpid())
        if action == "die":
            os._exit(_EXIT_INJECTED)
        if action == "exc":
            raise InjectedFault(f"injected fault at step {step}")
        if action == "hang":
            while True:  # heartbeat goes stale; the supervisor reaps us
                time.sleep(3600)
        return None


_injector: Optional[FaultInjector] = None


def fault_hook(step: int) -> Optional[str]:
    """Training-loop hook: fire any env-configured fault for ``step``.

    Returns ``"nan"`` when the loop should poison this step's loss,
    else ``None``. Costs one cached-injector check when ``SVC_FAULT_INJECT``
    is unset.
    """
    global _injector
    if _injector is None:
        _injector = FaultInjector.from_env()
    return _injector.fire(step)


def _reset_injector_for_tests() -> None:
    global _injector
    _injector = None


def heartbeat(step: int) -> None:
    """Touch this worker's heartbeat file (no-op unless the supervisor
    exported ``SVC_HEARTBEAT_DIR``). The supervisor treats a stale mtime
    as a hang."""
    d = os.environ.get(ENV_HEARTBEAT_DIR)
    if not d:
        return
    path = os.path.join(d, f"hb_{os.environ.get('SVC_PROCESS_ID', '0')}")
    with open(path, "w") as f:
        f.write(str(step))


@dataclass
class ElasticResult:
    restarts: int
    attempts: List[dict] = field(default_factory=list)  # per-attempt event dicts


class ElasticFailure(RuntimeError):
    def __init__(self, msg: str, result: ElasticResult):
        super().__init__(msg)
        self.result = result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_elastic(
    worker_argv: Sequence[str],
    num_workers: int = 1,
    max_restarts: int = 3,
    heartbeat_timeout: Optional[float] = None,
    heartbeat_dir: Optional[str] = None,
    startup_grace: Optional[float] = None,
    poll_interval: float = 0.2,
    grace_period: float = 5.0,
    extra_env: Optional[Dict[str, str]] = None,
    log_dir: Optional[str] = None,
) -> ElasticResult:
    """Supervise a gang of ``num_workers`` processes running ``worker_argv``.

    Each worker inherits the environment plus the rendezvous triple
    (``SVC_COORDINATOR`` on a fresh localhost port per attempt,
    ``SVC_NUM_PROCESSES``, ``SVC_PROCESS_ID``) when ``num_workers > 1``,
    the attempt counter (``SVC_ELASTIC_ATTEMPT``), and — when heartbeat
    monitoring is on — ``SVC_HEARTBEAT_DIR``. Workers are expected to
    checkpoint periodically and resume from the latest checkpoint on
    relaunch (``training.loop.train_diffusion`` does both).

    Success = every worker exits 0. On any nonzero/aborted exit or a
    heartbeat stale for longer than ``heartbeat_timeout`` seconds, the
    remaining workers are terminated (SIGTERM, then SIGKILL after
    ``grace_period``) and the gang is relaunched, at most
    ``max_restarts`` times; the budget exhausted raises
    :class:`ElasticFailure` carrying the per-attempt event history.

    The staleness clock only starts at a worker's FIRST beat — before
    step 0 a real worker is importing + jit-compiling, which can take
    minutes and must not read as a hang. ``startup_grace`` (seconds)
    optionally bounds that pre-first-beat window too.
    """
    log = get_logger("svc_tpu.elastic")
    if heartbeat_timeout is not None and heartbeat_dir is None:
        raise ValueError("heartbeat_timeout needs heartbeat_dir")
    result = ElasticResult(restarts=0)

    for attempt in range(max_restarts + 1):
        port = _free_port()
        procs: List[subprocess.Popen] = []
        logs = []
        t_start = time.time()
        for wid in range(num_workers):
            env = dict(os.environ)
            if extra_env:
                env.update(extra_env)
            env[ENV_ATTEMPT] = str(attempt)
            env["SVC_PROCESS_ID"] = str(wid)
            if num_workers > 1:
                env["SVC_COORDINATOR"] = f"127.0.0.1:{port}"
                env["SVC_NUM_PROCESSES"] = str(num_workers)
            if heartbeat_dir:
                os.makedirs(heartbeat_dir, exist_ok=True)
                env[ENV_HEARTBEAT_DIR] = heartbeat_dir
                # fresh mtimes so attempt N doesn't inherit stale files
                with open(os.path.join(heartbeat_dir, f"hb_{wid}"), "w") as f:
                    f.write("-1")
            out = None
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                out = open(os.path.join(log_dir, f"worker{wid}_a{attempt}.log"), "w")
                logs.append(out)
            procs.append(subprocess.Popen(
                list(worker_argv), env=env,
                stdout=out or None, stderr=subprocess.STDOUT if out else None,
            ))
        log.info("elastic attempt %d: launched %d worker(s) (coordinator port %d)",
                 attempt, num_workers, port)

        failure: Optional[str] = None
        try:
            while True:
                codes = [p.poll() for p in procs]
                if any(c not in (None, 0) for c in codes):
                    bad = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
                    failure = f"worker exit: {bad}"
                    break
                if all(c == 0 for c in codes):
                    break  # clean completion
                if heartbeat_timeout is not None:
                    now = time.time()
                    for wid, c in enumerate(codes):
                        if c is not None:
                            continue  # already exited cleanly
                        hb = os.path.join(heartbeat_dir, f"hb_{wid}")
                        try:
                            with open(hb) as f:
                                beaten = f.read().strip() != "-1"
                            age = now - os.path.getmtime(hb)
                        except OSError:
                            continue  # transient read race with the worker
                        if not beaten:
                            # pre-first-beat: import + first-step compile can
                            # legitimately take minutes
                            if startup_grace is not None and age > startup_grace:
                                failure = (f"worker {wid} no first heartbeat "
                                           f"after {age:.1f}s")
                                break
                            continue
                        if age > heartbeat_timeout:
                            failure = f"worker {wid} heartbeat stale {age:.1f}s"
                            break
                    if failure:
                        break
                time.sleep(poll_interval)
        finally:
            if failure is not None:
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                deadline = time.time() + grace_period
                for p in procs:
                    try:
                        p.wait(timeout=max(0.1, deadline - time.time()))
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
            for f in logs:
                f.close()

        event = {
            "attempt": attempt,
            "exit_codes": [p.poll() for p in procs],
            "duration_s": round(time.time() - t_start, 3),
            "failure": failure,
        }
        result.attempts.append(event)

        if failure is None:
            log.info("elastic attempt %d: gang completed cleanly", attempt)
            return result

        log.warning("elastic attempt %d failed (%s) — %s", attempt, failure,
                    "restarting from latest checkpoint"
                    if attempt < max_restarts else "restart budget exhausted")
        result.restarts += 1

    result.restarts = max_restarts  # budget spent; last attempt wasn't a restart
    raise ElasticFailure(
        f"gang failed {max_restarts + 1} attempts — see result.attempts", result
    )
