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
"""

from __future__ import annotations

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


def _state(pid: int) -> str:
    with open(f"/proc/{pid}/stat", encoding="utf-8") as fh:
        return fh.read().rsplit(")", 1)[1].split()[0]


def _cmdline(pid: int) -> str:
    with open(f"/proc/{pid}/cmdline", "rb") as fh:
        return fh.read().replace(b"\0", b" ").decode(errors="replace").strip()


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
