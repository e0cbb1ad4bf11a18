"""Failure recovery: auto-resume around the epoch loop and the RSS watchdog
(counterpart of virnet_tpu/train/resilience.py).

The reference has no failure handling (a crash is a manual restart with
--resume).  Checkpoints here carry the full train state
(train/checkpoint.py), so a crashed run resumes losslessly;
``run_with_auto_resume`` automates the retry with bounded restarts and a
growing back-off.

The RSS watchdog bounds host memory over long runs: kill/resume is bitwise
(cli/resilience_proof.py), so replacing the process image at an epoch
boundary costs nothing.  Right after the epoch's checkpoint is written, a
process whose resident set has crossed the limit ``os.execv``s itself
with ``--resume latest`` and continues from the same optimizer state with
a fresh heap.  In a run of several processes one rank cannot re-exec
alone (the others would wait on it in a collective, and a re-exec'd rank
cannot rejoin the group), so there the watchdog refuses to run.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from typing import Callable, List, Optional, Sequence

_RSS_RESTART_ENV = "VIRNET_TPU_TORCH_RSS_RESTARTS"


def rss_mb() -> float:
    """Current resident set size in MB from /proc (0.0 if unavailable)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return 0.0


def rss_restart_count() -> int:
    """How many RSS-triggered re-execs this lineage has performed."""
    try:
        return int(os.environ.get(_RSS_RESTART_ENV, "0"))
    except ValueError:
        return 0


def reexec_argv(module: str, argv: Optional[Sequence[str]] = None
                ) -> List[str]:
    """The ``os.execv`` argv that relaunches a trainer CLI: this
    interpreter, ``-m module`` and the CLI's arguments with every
    ``--resume N`` and ``--resume=N`` taken out and ``--resume latest``
    appended, so that the new process restores the checkpoint the old one
    just wrote and not the epoch it was started from."""
    args = list(sys.argv[1:] if argv is None else argv)
    kept: List[str] = []
    i = 0
    while i < len(args):
        if args[i] == "--resume":
            i += 2
            continue
        if not args[i].startswith("--resume="):
            kept.append(args[i])
        i += 1
    return [sys.executable, "-m", module, *kept, "--resume", "latest"]


def check_watchdog_world(limit_mb: float, world: int) -> None:
    """Raise when the watchdog is on in a run of several processes."""
    if limit_mb and limit_mb > 0 and world > 1:
        raise RuntimeError(
            f"rss_limit_mb={limit_mb:g} with {world} processes: the RSS "
            f"watchdog re-execs one process, which cannot rejoin the "
            f"process group the other ranks are waiting in; run the "
            f"watchdog single-process or set rss_limit_mb to 0")


def maybe_reexec_on_rss(limit_mb: float, exec_argv: Sequence[str],
                        log_fn=print, cleanup: Optional[Callable] = None,
                        world: int = 1, _exec=None, _rss=None) -> bool:
    """Re-exec the process when RSS reaches ``limit_mb`` (<= 0 disables).

    Call right after the epoch's checkpoint is written.  Returns False
    (below the limit, or disabled) or replaces the process image and
    never returns.  ``cleanup`` runs before the exec (flush TensorBoard,
    close files); an error in it is logged and the exec goes on.  The
    restart count rides across the exec in the environment, so the logs
    show the lineage.  Raises with ``world`` > 1
    (``check_watchdog_world``).  ``_exec`` / ``_rss`` are test seams.
    """
    check_watchdog_world(limit_mb, world)
    if not limit_mb or limit_mb <= 0:
        return False
    cur = float(_rss() if _rss is not None else rss_mb())
    if cur < limit_mb:
        return False
    n = rss_restart_count() + 1
    os.environ[_RSS_RESTART_ENV] = str(n)
    log_fn(f"RSS watchdog: {cur:.0f} MB >= limit {limit_mb:.0f} MB, "
           f"re-exec #{n} with --resume latest")
    if cleanup is not None:
        try:
            cleanup()
        except Exception:
            log_fn("RSS watchdog: cleanup raised\n" + traceback.format_exc())
    sys.stdout.flush()
    sys.stderr.flush()
    (_exec if _exec is not None else os.execv)(exec_argv[0], list(exec_argv))
    return True  # only reachable through the _exec seam


def run_with_auto_resume(train_fn: Callable[[int], None],
                         restore_fn: Callable[[], int],
                         max_restarts: int = 3,
                         backoff_s: float = 10.0,
                         log_fn=print) -> None:
    """Run ``train_fn(epoch_start)``, restarting from ``restore_fn()`` (the
    epoch to resume from, 0 without a checkpoint) after a failure, with a
    back-off of ``backoff_s`` times the restart count.  Re-raises after
    ``max_restarts`` failures."""
    restarts = 0
    while True:
        epoch_start = restore_fn()
        try:
            train_fn(epoch_start)
            return
        except KeyboardInterrupt:
            raise
        except Exception:
            restarts += 1
            log_fn(f"training crashed (restart {restarts}/{max_restarts}):\n"
                   f"{traceback.format_exc()}")
            if restarts > max_restarts:
                raise
            time.sleep(backoff_s * restarts)
