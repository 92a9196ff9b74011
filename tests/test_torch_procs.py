"""The port's one way to start a child process
(``gist_tpu_torch/bench/procs.py``): whatever ends the wait, no process
of the child's group outlives the call, and ``descendants`` sees what a
process has left running."""

import os
import signal
import subprocess
import time

import pytest

from gist_tpu_torch.bench import procs


def _new_descendants(before, wait_s=2.0):
    """This process's live descendants that were not in ``before``, after
    giving killed ones ``wait_s`` to be reaped."""
    old = {pid for pid, _ in before}
    deadline = time.time() + wait_s
    while True:
        new = [d for d in procs.descendants() if d[0] not in old]
        if not new or time.time() > deadline:
            return new
        time.sleep(0.1)


def test_timeout_ends_the_whole_group():
    """``sh -c 'sleep 60 & sleep 60'`` cut by a 1 s timeout: both sleeps
    end with the shell."""
    before = procs.descendants()
    t0 = time.time()
    with pytest.raises(subprocess.TimeoutExpired):
        procs.run_child(["sh", "-c", "sleep 60 & sleep 60"], 1)
    assert time.time() - t0 < 1 + procs.GRACE_S + 5
    assert _new_descendants(before) == []


def test_exception_while_waiting_ends_the_whole_group():
    """An exception raised in the waiting thread (here from a signal
    handler) ends the child's group too, and propagates."""
    before = procs.descendants()

    def boom(*_):
        raise RuntimeError("interrupted")

    old = signal.signal(signal.SIGALRM, boom)
    signal.setitimer(signal.ITIMER_REAL, 0.5)
    try:
        with pytest.raises(RuntimeError, match="interrupted"):
            procs.run_child(["sh", "-c", "sleep 60 & sleep 60"])
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    assert _new_descendants(before) == []


def test_a_straggler_holding_the_pipes_is_ended():
    """A child that exits while its background job still holds the
    captured pipes returns at once with its output; the job is ended."""
    before = procs.descendants()
    t0 = time.time()
    res = procs.run_child(["sh", "-c", "echo hi; sleep 60 & echo bye"], 30,
                          capture_output=True, text=True)
    assert time.time() - t0 < 10
    assert res.returncode == 0 and res.stdout.split() == ["hi", "bye"]
    assert _new_descendants(before) == []


def test_run_children_waits_for_all_before_raising(tmp_path):
    """``check`` raises for a failed child only after every child has
    been waited for."""
    done = tmp_path / "done"
    with pytest.raises(subprocess.CalledProcessError):
        procs.run_children([["sh", "-c", "exit 3"],
                            ["sh", "-c", f"sleep 0.5; touch {done}"]],
                           30, check=True)
    assert done.exists()
    res = procs.run_children([["sh", "-c", "exit 3"], ["true"]], 30)
    assert [r.returncode for r in res] == [3, 0]


def test_descendants_and_kill():
    """``descendants`` lists a live child with its command line; ``kill``
    ends it; a reaped child is listed no more."""
    p = subprocess.Popen(["sleep", "60"])
    try:
        found = dict(procs.descendants())
        assert found.get(p.pid) == "sleep 60"
        procs.kill([p.pid])
        assert p.wait(timeout=10) == -signal.SIGKILL
        assert p.pid not in dict(procs.descendants())
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert os.getpid() not in dict(procs.descendants())


def test_run_world_ends_a_world_past_its_limit(tmp_path):
    """A gloo world whose rank 1 never returns (and has started a child
    of its own) is ended at its limit: ``run_world`` raises
    ``TimeoutError`` naming the case and rank 1, and neither a rank nor
    the rank's child is left running."""
    from torch_dist_workers import run_world
    before = procs.descendants()
    pid_file = tmp_path / "child.pid"
    t0 = time.time()
    with pytest.raises(TimeoutError, match=r"'stuck'.*ranks \[(0, )?1\]"):
        run_world(2, [("stuck", dict(fn="hang"))],
                  {"pid_file": str(pid_file)}, timeout_s=20, init=False)
    assert time.time() - t0 < 20 + procs.GRACE_S + 10
    # the spawn context's resource tracker lives as long as this process
    assert [d for d in _new_descendants(before)
            if "resource_tracker" not in d[1]] == []
    child = int(pid_file.read_text())
    try:
        assert procs._state(child) == "Z"    # killed, not yet reaped
    except FileNotFoundError:
        pass                                 # killed and reaped
