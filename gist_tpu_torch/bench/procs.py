"""The one way the port's scripts start a child process, and a look at
what a process has left running.

Every child starts in a session (and so a process group) of its own and
is waited for inside ``try``/``finally``.  Whatever ends the wait (the
child's exit, a timeout, an exception, ``KeyboardInterrupt``), the
child's whole group is then ended: SIGTERM to a group whose leader still
runs, a few seconds' grace, SIGKILL to the group, and a last wait.  So a
grandchild (``sh -c 'job &'``, a launcher's workers) never outlives the
call that started it.

:func:`descendants` lists this process's live descendants by walking
``/proc/<pid>/task/*/children`` (read only).

Ranks spawned by ``torch.multiprocessing`` get the same treatment: each
calls :func:`own_group` first, and :func:`join_spawned` waits for them
within a limit and ends every rank's group however the wait ends.
"""

from __future__ import annotations

import datetime
import os
import signal
import subprocess
import time

GRACE_S = 5.0


def _signal_group(pgid: int, sig) -> None:
    try:
        os.killpg(pgid, sig)
    except ProcessLookupError:
        pass


def _end_groups(procs, grace: float = GRACE_S) -> None:
    """SIGTERM to the group of every leader still running, wait up to
    ``grace`` seconds for them, then SIGKILL to every group (its
    stragglers included) and reap every leader."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        _signal_group(p.pid, signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in live:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        _signal_group(p.pid, signal.SIGKILL)
    for p in procs:
        p.wait()


def _wait(p, deadline):
    """(stdout, stderr) of ``p`` once it has exited.  A straggler of its
    group that still holds its pipes after it exited is killed, so that
    the pipes close; past ``deadline`` this raises ``TimeoutExpired``."""
    while True:
        left = None if deadline is None else deadline - time.monotonic()
        try:
            return p.communicate(timeout=0.5 if left is None
                                 else max(min(left, 0.5), 0.0))
        except subprocess.TimeoutExpired:
            if p.poll() is not None:
                _signal_group(p.pid, signal.SIGKILL)
            elif left is not None and left <= 0:
                raise


def run_children(cmds, timeout=None, *, check: bool = False,
                 capture_output: bool = False, text: bool = False,
                 **popen_kw) -> list:
    """Start every command of ``cmds`` at once, each in a session of its
    own, and wait for all of them (``timeout`` seconds in all); returns
    their ``subprocess.CompletedProcess`` in order.  With ``check`` a
    non-zero exit raises ``CalledProcessError`` for the first such
    command, after every child has been waited for.  A timeout raises
    ``subprocess.TimeoutExpired``; then, as after any exception, every
    child's group is ended (:func:`_end_groups`)."""
    if capture_output:
        popen_kw.update(stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = None if timeout is None else time.monotonic() + timeout
    procs, done = [], []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, start_new_session=True,
                                          text=text, **popen_kw))
        for p in procs:
            out, err = _wait(p, deadline)
            done.append(subprocess.CompletedProcess(p.args, p.returncode,
                                                    out, err))
    finally:
        _end_groups(procs)
    for r in done:
        if check:
            r.check_returncode()
    return done


def run_child(cmd, timeout=None, **kw) -> subprocess.CompletedProcess:
    """One child, as :func:`run_children` runs each."""
    return run_children([cmd], timeout, **kw)[0]


def own_group() -> None:
    """Make the calling rank the leader of a session (and so a process
    group) of its own, which :func:`join_spawned` ends with everything
    the rank started."""
    os.setsid()


def rank_timeout(timeout_s: float) -> datetime.timedelta:
    """A rank's collective and rendezvous timeout inside a world limited
    to ``timeout_s`` seconds: three quarters of it, so a rank stuck in a
    collective raises on the rank before the world's limit ends it
    (gloo's and NCCL's defaults are 30 and 10 minutes)."""
    return datetime.timedelta(seconds=max(0.75 * timeout_s, 1.0))


def _signal_rank(pid: int, sig) -> None:
    """``sig`` to the group ``pid`` leads, or to ``pid`` alone where it
    has not made its group yet."""
    try:
        if os.getpgid(pid) == pid:
            os.killpg(pid, sig)
        else:
            os.kill(pid, sig)
    except ProcessLookupError:
        pass


def end_ranks(processes, grace: float = GRACE_S) -> None:
    """SIGTERM to every rank still running (its group), up to ``grace``
    seconds for them to go, SIGKILL to those left, SIGKILL to every
    rank's group (a straggler of a rank that has gone), every rank
    reaped."""
    live = [p for p in processes if p.is_alive()]
    for p in live:
        _signal_rank(p.pid, signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in live:
        p.join(timeout=max(deadline - time.monotonic(), 0.0))
    for p in live:
        _signal_rank(p.pid, signal.SIGKILL)
    for p in processes:
        _signal_group(p.pid, signal.SIGKILL)
        p.join()


def join_spawned(ctx, timeout_s: float, what: str) -> None:
    """Wait for the ranks of ``ctx`` (``torch.multiprocessing.
    start_processes(..., join=False)``) for at most ``timeout_s``
    seconds.  A rank that raises ends the wait at once
    (``ProcessRaisedException``, as ``join=True`` would); past the limit
    this raises ``TimeoutError`` naming ``what`` and the ranks still
    running.  However the wait ends, every rank still running is then
    ended with its group (:func:`end_ranks`)."""
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=min(max(deadline - time.monotonic(),
                                           0.0), 1.0)):
            if time.monotonic() >= deadline:
                left = [r for r, p in enumerate(ctx.processes)
                        if p.is_alive()]
                raise TimeoutError(
                    f"{what}: {len(ctx.processes)} ranks passed their "
                    f"{timeout_s:.0f} s limit; ranks {left} were still "
                    f"running and were ended")
    finally:
        end_ranks(ctx.processes)


def _state(pid: int) -> str:
    with open(f"/proc/{pid}/stat", encoding="utf-8") as fh:
        return fh.read().rsplit(")", 1)[1].split()[0]


def _cmdline(pid: int, tries: int = 20) -> str:
    """``pid``'s command line.  A process caught inside ``execve`` reads
    an empty one for a moment (a child that ``subprocess.Popen`` has
    just started, under load): read again for up to ~0.1 s."""
    for _ in range(tries):
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            line = fh.read().replace(b"\0", b" ")
        if line.strip():
            break
        time.sleep(0.005)
    return line.decode(errors="replace").strip()


def descendants(pid: int = None) -> list:
    """``[(pid, command line), ...]`` of the live (not zombie)
    descendants of ``pid`` (default this process), parents before their
    children."""
    pid = os.getpid() if pid is None else pid
    out, todo = [], [pid]
    while todo:
        parent = todo.pop(0)
        try:
            tasks = os.listdir(f"/proc/{parent}/task")
        except FileNotFoundError:
            continue
        for task in tasks:
            try:
                with open(f"/proc/{parent}/task/{task}/children",
                          encoding="utf-8") as fh:
                    kids = [int(k) for k in fh.read().split()]
            except FileNotFoundError:
                continue
            for kid in kids:
                try:
                    if _state(kid) == "Z":
                        continue
                    out.append((kid, _cmdline(kid)))
                except FileNotFoundError:
                    continue
                todo.append(kid)
    return out


def kill(pids) -> None:
    """SIGKILL each of ``pids``' process group, or the process alone
    where it shares this process's group."""
    own = os.getpgrp()
    for pid in pids:
        try:
            pgid = os.getpgid(pid)
            if pgid == own:
                os.kill(pid, signal.SIGKILL)
            else:
                os.killpg(pgid, signal.SIGKILL)
        except ProcessLookupError:
            pass
