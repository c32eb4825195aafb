"""Training supervisor — preemption-to-resume with zero operator action
(the port of ``paddle_tpu/resilience/supervisor.py``).

:class:`TrainingSupervisor` is the per-node daemon that closes the loop:

- it runs the trainer as a **child process** and watches it;
- a clean exit (0) ends the job; ``ELASTIC_EXIT_CODE`` (a worker
  *requesting* relaunch, the reference fleet-elastic contract) or any
  crash triggers a **relaunch with jittered backoff**, up to
  ``max_restarts``;
- with an :class:`~paddle_tpu_torch.distributed.fleet.elastic.ElasticManager`
  attached it **rendezvouses** (waits for the expected membership,
  retrying over transient store outages) before every launch and keeps
  probing membership while the child runs — a lost peer terminates the
  local child and re-enters the relaunch path (reason ``lost_node``);
- every launch exports the resume contract to the child:
  ``PADDLE_ELASTIC_RESUME_DIR`` (the checkpoint directory the trainer
  passes to ``Model.fit(resume_from=...)``) and
  ``PADDLE_RESTART_ATTEMPT``.  ``fit(resume_from=...)`` treats an empty
  directory as a fresh start, so the first launch and the Nth relaunch
  are one code path.

Between attempts the supervisor opens the checkpoint directory (no
child is alive then, so the manager's orphan-``.tmp`` sweep is safe)
and logs the step the relaunch will resume from, with the recovery
history the newest manifest carries (skipped data windows, integrity
repairs).

With a ``hang_watchdog`` attached (a
:class:`~paddle_tpu_torch.observability.flight.HangWatchdog` in observer
mode, or any object with ``check()``/``write_bundle()``/``reset()``),
the supervisor also escalates on **cross-rank collective hangs**: a
wedged child never exits, so exit-code watching alone would wait
forever.  ``on_hang="bundle+restart"`` (the default) dumps a
supervisor-side debug bundle, terminates the hung child and re-enters
the relaunch path (reason ``hang``); ``on_hang="restart"`` skips the
bundle.  The watchdog is ``reset()`` whenever a world ends (a hang, a
crash, a lost node), so the relaunched world re-baselines instead of
re-firing on the dead run's stale heartbeats.

Telemetry: ``supervisor_restarts_total{reason=elastic_exit|crash|
lost_node|spawn_failed|hang}``, the ``supervisor_child_up`` gauge, and
``supervisor::launch`` / ``supervisor::relaunch`` trace spans.

Fault sites (see :mod:`.faults`): ``supervisor.spawn`` fires before
every child spawn (an ``io_error`` there is a relaunch that itself
dies — retried out of the same restart budget);
``supervisor.rendezvous`` fires before every membership wait (an
``io_error`` is a store outage mid-rendezvous — retried with backoff
under the rendezvous deadline, never read as "the fleet died").
"""
from __future__ import annotations

import logging
import os
import subprocess
import sys
import time

from .faults import fault_point
from .retry import Deadline, backoff_delays

from ..distributed.fleet.elastic import ELASTIC_EXIT_CODE

__all__ = ["TrainingSupervisor", "ENV_RESUME_DIR", "ENV_ATTEMPT",
           "ELASTIC_EXIT_CODE"]

logger = logging.getLogger("paddle_tpu_torch.resilience")

#: env var naming the checkpoint directory the child resumes from
ENV_RESUME_DIR = "PADDLE_ELASTIC_RESUME_DIR"
#: env var carrying the 0-based launch attempt (same name the launcher
#: uses, so scripts written for either supervisor read one contract)
ENV_ATTEMPT = "PADDLE_RESTART_ATTEMPT"


class TrainingSupervisor:
    """Run, watch, and autonomously relaunch one trainer process.

    ``cmd`` is the trainer argv (e.g. ``[sys.executable, "train.py"]``).
    ``checkpoint_dir`` is exported to the child as
    :data:`ENV_RESUME_DIR`; the trainer is expected to pass it to
    ``Model.fit(resume_from=...)`` (via a ``CheckpointCallback`` on the
    same directory), which makes every relaunch resume from the newest
    intact checkpoint with no supervisor-side state transfer.

    ``elastic``/``hosts`` attach fleet membership: the supervisor
    registers the manager, rendezvouses before each launch and watches
    peers while the child runs.  ``env`` (default: this process's
    environment) is the child's base environment; the resume contract
    is overlaid on top.
    """

    def __init__(self, cmd, checkpoint_dir=None, max_restarts=3,
                 backoff_base=0.2, backoff_cap=10.0, jitter=True,
                 elastic=None, hosts=(), poll_interval=0.05,
                 membership_interval=0.5, rendezvous_timeout=60.0,
                 term_grace_s=10.0, env=None, log_path=None, rng=None,
                 registry=None, tracer=None, hang_watchdog=None,
                 on_hang="bundle+restart"):
        self.cmd = list(cmd)
        self.checkpoint_dir = checkpoint_dir
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.jitter = bool(jitter)
        self.elastic = elastic
        self.hosts = list(hosts)
        self.poll_interval = float(poll_interval)
        self.membership_interval = float(membership_interval)
        self.rendezvous_timeout = float(rendezvous_timeout)
        self.term_grace_s = float(term_grace_s)
        self.env = env
        self.log_path = log_path
        self._rng = rng
        self._registry = registry
        self._tracer = tracer
        self.hang_watchdog = hang_watchdog
        if on_hang not in ("bundle+restart", "restart"):
            raise ValueError(f"unknown on_hang policy {on_hang!r}")
        self.on_hang = on_hang
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

    def _terminate(self, child):
        if child.poll() is None:
            child.terminate()
            try:
                child.wait(timeout=self.term_grace_s)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()

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

    # ---- membership -----------------------------------------------------
    def _rendezvous(self):
        """Wait until fleet membership matches, retrying transient store
        failures with backoff (a blipping TCPStore during rendezvous
        must not read as a dead fleet)."""
        if self.elastic is None or not self.hosts:
            return
        dl = Deadline(self.rendezvous_timeout)
        delays = backoff_delays(base=self.backoff_base, cap=1.0,
                                jitter=self.jitter, rng=self._rng)
        while True:
            try:
                fault_point("supervisor.rendezvous")
                if self.elastic.wait_for_np(
                        self.hosts, timeout=max(1.0, dl.remaining())):
                    return
            except (OSError, RuntimeError) as e:
                logger.warning("supervisor: rendezvous store error "
                               "(retrying): %s", e)
            if dl.expired():
                raise TimeoutError(
                    f"rendezvous: membership never reached "
                    f"np={self.elastic.np} within "
                    f"{self.rendezvous_timeout}s")
            dl.sleep(next(delays))

    def _membership_lost(self):
        """Dead peer list, or [] — including on transient store errors
        (a blip is not a death; the next probe round decides)."""
        try:
            return [h for h in self.hosts if not self.elastic.probe(h)]
        except (OSError, RuntimeError):
            return []

    # ---- the loop -------------------------------------------------------
    def _hang_detected(self):
        """Probe the attached hang watchdog (False without one, and on
        probe errors — a broken watchdog must not kill a healthy
        child)."""
        if self.hang_watchdog is None:
            return False
        try:
            return bool(self.hang_watchdog.check())
        except Exception:
            return False

    def _escalate_hang(self, child):
        """The ``on_hang`` escalation: dump (policy permitting), kill
        the wedged child, reset the watchdog for the relaunch."""
        logger.error("supervisor: cross-rank hang detected — "
                     "escalating with policy %r", self.on_hang)
        if "bundle" in self.on_hang:
            try:
                self.hang_watchdog.write_bundle(reason="supervisor_hang")
            except Exception:
                logger.exception("supervisor: hang bundle write failed")
        self._terminate(child)
        self._child_up(False)
        self._forget_world()

    def _forget_world(self):
        """Reset the attached watchdog once a world has ended, whatever
        ended it: the relaunched world re-baselines, and the observer
        stops reading the dead world's last heartbeats."""
        if self.hang_watchdog is None:
            return
        try:
            self.hang_watchdog.reset()
        except Exception:
            pass    # silent-ok: advisory reset — a stale beat is read
                    # until the relaunched rank overwrites it

    def _watch(self, child):
        """Block until the child exits, membership breaks, or the hang
        watchdog fires.  Returns ``("ok"|"elastic_exit"|"crash"|
        "lost_node"|"hang", exit_code)``."""
        elastic_code = ELASTIC_EXIT_CODE
        next_probe = time.monotonic() + self.membership_interval
        # lint-ok: bounded-retries the watch loop is bounded by the
        # child's lifetime (poll() returning), not by a deadline
        while True:
            code = child.poll()
            if code is not None:
                self._child_up(False)
                if code == 0:
                    return ("ok", 0)
                if code == elastic_code:
                    return ("elastic_exit", code)
                return ("crash", code)
            if time.monotonic() >= next_probe:
                if self.elastic is not None and self.hosts:
                    dead = self._membership_lost()
                    if dead:
                        logger.warning("supervisor: lost node(s) %s — "
                                       "terminating local trainer for "
                                       "relaunch", dead)
                        self._terminate(child)
                        self._child_up(False)
                        return ("lost_node", elastic_code)
                if self._hang_detected():
                    self._escalate_hang(child)
                    return ("hang", elastic_code)
                next_probe = time.monotonic() + self.membership_interval
            time.sleep(self.poll_interval)

    def run(self):
        """Supervise until the trainer completes or the restart budget
        is exhausted.  Returns the final exit code (0 = success)."""
        delays = backoff_delays(base=self.backoff_base,
                                cap=self.backoff_cap, jitter=self.jitter,
                                rng=self._rng)
        registered = False
        if self.elastic is not None:
            self.elastic.register()
            registered = True
        try:
            self.attempt = 0
            while True:
                self._rendezvous()
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
                if reason != "hang":       # _escalate_hang reset it
                    self._forget_world()
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
            if registered:
                try:
                    self.elastic.deregister()
                except (OSError, RuntimeError):
                    pass


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
