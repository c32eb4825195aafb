"""Training supervisor — preemption-to-resume with zero operator action
(the port of ``paddle_tpu/resilience/supervisor.py``).

:class:`TrainingSupervisor` runs the trainer as a **child process** and
watches it: a clean exit (0) ends the job; ``ELASTIC_EXIT_CODE`` (a
worker *requesting* relaunch) or any crash triggers a **relaunch with
jittered backoff**, up to ``max_restarts``.  Every launch exports the
resume contract to the child: ``PADDLE_ELASTIC_RESUME_DIR`` (the
checkpoint directory the trainer passes to ``Model.fit(resume_from=...)``)
and ``PADDLE_RESTART_ATTEMPT``.  ``fit(resume_from=...)`` treats an empty
directory as a fresh start, so the first launch and the Nth relaunch are
one code path.

Between attempts the supervisor opens the checkpoint directory (no child
is alive then, so the manager's orphan-``.tmp`` sweep is safe) and logs
the step the relaunch will resume from, with the recovery history the
newest manifest carries (skipped data windows, integrity repairs).

The JAX supervisor's fleet membership (``elastic=``, over its
``fleet/elastic.py``) and its cross-rank hang escalation
(``hang_watchdog=``, over its ``observability/flight.py``) wait for those
modules to be ported: passing either raises ``NotImplementedError``.

Telemetry: ``supervisor_restarts_total{reason=elastic_exit|crash|
spawn_failed}``, the ``supervisor_child_up`` gauge, and
``supervisor::launch`` / ``supervisor::relaunch`` trace spans.  Fault
site: ``supervisor.spawn`` fires before every child spawn (an
``io_error`` there is a relaunch that itself dies, retried out of the
same restart budget).
"""
from __future__ import annotations

import logging
import os
import subprocess
import sys
import time

from .faults import fault_point
from .retry import backoff_delays

__all__ = ["TrainingSupervisor", "ENV_RESUME_DIR", "ENV_ATTEMPT",
           "ELASTIC_EXIT_CODE"]

logger = logging.getLogger("paddle_tpu_torch.resilience")

#: env var naming the checkpoint directory the child resumes from
ENV_RESUME_DIR = "PADDLE_ELASTIC_RESUME_DIR"
#: env var carrying the 0-based launch attempt (same name the launcher
#: uses, so scripts written for either supervisor read one contract)
ENV_ATTEMPT = "PADDLE_RESTART_ATTEMPT"
#: a worker's exit code asking for a relaunch (the JAX package's
#: ``fleet/elastic.py`` value, the reference fleet-elastic contract)
ELASTIC_EXIT_CODE = 101


class TrainingSupervisor:
    """Run, watch, and autonomously relaunch one trainer process.

    ``cmd`` is the trainer argv (e.g. ``[sys.executable, "train.py"]``).
    ``checkpoint_dir`` is exported to the child as
    :data:`ENV_RESUME_DIR`; the trainer is expected to pass it to
    ``Model.fit(resume_from=...)`` (via a ``CheckpointCallback`` on the
    same directory), which makes every relaunch resume from the newest
    intact checkpoint with no supervisor-side state transfer.

    ``env`` (default: this process's environment) is the child's base
    environment; the resume contract is overlaid on top.  ``elastic``,
    ``hosts`` and ``hang_watchdog`` (with their ``membership_interval``,
    ``rendezvous_timeout``, ``term_grace_s`` and ``on_hang``) are the
    JAX signature's: the first three raise when given, the others are
    unused.
    """

    def __init__(self, cmd, checkpoint_dir=None, max_restarts=3,
                 backoff_base=0.2, backoff_cap=10.0, jitter=True,
                 elastic=None, hosts=(), poll_interval=0.05,
                 membership_interval=0.5, rendezvous_timeout=60.0,
                 term_grace_s=10.0, env=None, log_path=None, rng=None,
                 registry=None, tracer=None, hang_watchdog=None,
                 on_hang="bundle+restart"):
        if elastic is not None or hosts:
            raise NotImplementedError(
                "TrainingSupervisor(elastic=...): fleet membership needs "
                "fleet/elastic.py, which the port has not taken over yet "
                "(see ROADMAP.md)")
        if hang_watchdog is not None:
            raise NotImplementedError(
                "TrainingSupervisor(hang_watchdog=...): the hang watchdog "
                "is observability/flight.py, which the port has not taken "
                "over yet (see ROADMAP.md)")
        self.cmd = list(cmd)
        self.checkpoint_dir = checkpoint_dir
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.jitter = bool(jitter)
        self.poll_interval = float(poll_interval)
        self.env = env
        self.log_path = log_path
        self._rng = rng
        self._registry = registry
        self._tracer = tracer
        self.attempt = 0            # current launch attempt (0 = first)
        self.restarts = []          # [(reason, attempt)] audit log

    # ---- wiring ---------------------------------------------------------
    def registry(self):
        if self._registry is None:
            from ..observability.metrics import default_registry

            self._registry = default_registry()
        return self._registry

    def tracer(self):
        if self._tracer is None:
            from ..observability.tracing import default_tracer

            self._tracer = default_tracer()
        return self._tracer

    def _restart_counter(self):
        return self.registry().counter(
            "supervisor_restarts_total",
            "trainer relaunches by the training supervisor",
            labelnames=("reason",))

    def _child_up(self, up):
        self.registry().gauge(
            "supervisor_child_up",
            "1 while the supervised trainer process is running",
        ).set(1 if up else 0)

    # ---- child lifecycle ------------------------------------------------
    def _child_env(self, attempt):
        env = dict(self.env if self.env is not None else os.environ)
        env[ENV_ATTEMPT] = str(attempt)
        if self.checkpoint_dir is not None:
            env[ENV_RESUME_DIR] = os.fspath(self.checkpoint_dir)
        return env

    def _spawn(self, attempt):
        fault_point("supervisor.spawn")
        logf = None
        if self.log_path:
            # lint-ok: atomic-writes append-style run transcript that
            # must be open BEFORE the child exists; a torn line is
            # cosmetic
            logf = open(self.log_path, "a" if attempt else "w")
            if attempt:
                logf.write(f"\n----- restart attempt {attempt} -----\n")
                logf.flush()
        try:
            child = subprocess.Popen(
                self.cmd, env=self._child_env(attempt),
                stdout=logf if logf is not None else None,
                stderr=subprocess.STDOUT if logf is not None else None)
        finally:
            if logf is not None:
                logf.close()    # the child holds its own fd now
        span = self.tracer().start_trace(
            "supervisor::launch",
            attributes={"attempt": attempt, "pid": child.pid,
                        **self._resume_evidence()})
        span.end()
        self._child_up(True)
        return child

    def _resume_step(self):
        """The committed step a relaunch will resume from (None when no
        checkpoint directory or no intact checkpoint exists yet).  Also
        the point where orphaned ``.tmp`` save debris from the killed
        child is swept — no other writer is alive here."""
        if self.checkpoint_dir is None:
            return None
        from .checkpoint_manager import CheckpointManager

        try:
            return CheckpointManager(self.checkpoint_dir).latest()
        except OSError:
            return None

    def _resume_evidence(self):
        """Resume step plus the newest manifest's recovery history:
        skipped data windows (poisoned-batch rollbacks) and integrity
        repairs (silent-corruption rewind-and-replay) ride in the
        checkpoint ``extra``, so the supervisor's relaunch telemetry
        records what the previous life of this trainer already
        survived — not just where it resumes."""
        step = self._resume_step()
        out = {"resume_step": step}
        if step is None:
            return out
        try:
            from ..distributed.checkpoint import _load_manifest
            from .checkpoint_manager import CheckpointManager

            extra = _load_manifest(
                CheckpointManager(
                    self.checkpoint_dir,
                    sweep_orphans=False).step_path(step)).get("extra", {})
        except (OSError, ValueError, KeyError):
            return out
        windows = extra.get("skipped_windows") or []
        repairs = extra.get("repairs") or []
        if windows:
            out["skipped_windows"] = len(windows)
            out["last_rollback_reason"] = windows[-1].get("reason")
        if repairs:
            out["integrity_repairs"] = len(repairs)
            out["last_repair_reason"] = repairs[-1].get("reason")
        return out

    # ---- the loop -------------------------------------------------------
    def _watch(self, child):
        """Block until the child exits; returns ``("ok"|"elastic_exit"|
        "crash", exit_code)``."""
        # lint-ok: bounded-retries the watch loop is bounded by the
        # child's lifetime (poll() returning), not by a deadline
        while True:
            code = child.poll()
            if code is not None:
                self._child_up(False)
                if code == 0:
                    return ("ok", 0)
                if code == ELASTIC_EXIT_CODE:
                    return ("elastic_exit", code)
                return ("crash", code)
            time.sleep(self.poll_interval)

    def run(self):
        """Supervise until the trainer completes or the restart budget
        is exhausted.  Returns the final exit code (0 = success)."""
        delays = backoff_delays(base=self.backoff_base,
                                cap=self.backoff_cap, jitter=self.jitter,
                                rng=self._rng)
        try:
            self.attempt = 0
            while True:
                try:
                    child = self._spawn(self.attempt)
                except OSError as e:
                    logger.warning("supervisor: spawn failed "
                                   "(attempt %d): %s", self.attempt, e)
                    reason, code = "spawn_failed", 1
                else:
                    reason, code = self._watch(child)
                if reason == "ok":
                    return 0
                if self.attempt >= self.max_restarts:
                    logger.error(
                        "supervisor: %s (exit %s) with restart budget "
                        "exhausted after attempt %d — giving up",
                        reason, code, self.attempt)
                    return code or 1
                self.attempt += 1
                self.restarts.append((reason, self.attempt))
                self._restart_counter().labels(reason=reason).inc()
                backoff = next(delays)
                span = self.tracer().start_trace(
                    "supervisor::relaunch",
                    attributes={"reason": reason, "attempt": self.attempt,
                                "exit_code": code, "backoff_s": backoff,
                                **self._resume_evidence()})
                span.end()
                logger.warning(
                    "supervisor: trainer %s (exit %s) — relaunching "
                    "(attempt %d/%d) after %.2fs, resuming from step %s",
                    reason, code, self.attempt, self.max_restarts,
                    backoff, self._resume_step())
                time.sleep(backoff)
        finally:
            self._child_up(False)


def main(argv=None):  # pragma: no cover - thin CLI shim over the class
    """``python -m paddle_tpu_torch.resilience.supervisor --checkpoint-dir d
    -- trainer.py args...`` — supervise a trainer from the shell."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.resilience.supervisor",
        description="Autonomously relaunch a training script, resuming "
                    "from its newest intact checkpoint")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--log-path", default=None)
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="trainer command (prefix with --)")
    args = p.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        p.error("no trainer command given")
    if cmd[0].endswith(".py"):
        cmd = [sys.executable, *cmd]
    sup = TrainingSupervisor(cmd, checkpoint_dir=args.checkpoint_dir,
                             max_restarts=args.max_restarts,
                             log_path=args.log_path)
    return sup.run()


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
