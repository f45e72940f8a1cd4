"""Spawned worlds of ranks over gloo for the port's multi-rank tests.

A world is W processes of one test file run as a script (the file ends
with ``sys.exit(serve(TASKS))``), each joined by ``init_parallel_env``
from the launcher's variables; the controller (the pytest process) names
a ``task_*`` function and its arguments through a ``TCPStore``, and every
rank sends back its result.  The ranks import torch and the port, never
jax.  One world is started per size per module and shared by its tests
(``tests/test_torch_distributed.py``, ``test_torch_fleet.py``,
``test_torch_sharding.py``, ``test_torch_pipeline.py``,
``test_torch_hybrid_step.py``; ``test_torch_cuda.py``'s ranks on the
card).

A world on the CPU is one process that imports what every rank needs
once and then forks its W ranks: a rank's own start (torch, the port,
and the compiler front end that ``torch.utils.checkpoint`` loads on its
first call) costs ~6 CPU-seconds, W times over otherwise.  Ranks on a
card are W processes of their own (CUDA does not survive a fork).
"""

import os
import pickle
import signal
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORK = "TORCH_WORLD_FORK"       # set: the process forks this many ranks


def _rank_env(r):
    return dict(PADDLE_TRAINER_ID=str(r),
                PADDLE_CURRENT_ENDPOINT=f"127.0.0.1:{7000 + r}")


def serve(tasks) -> int:
    """A rank: join the job, then run the controller's tasks (with
    ``TORCH_WORLD_FORK`` set: fork the world's ranks first)."""
    if os.environ.get(FORK):
        return _fork(tasks, int(os.environ.pop(FORK)))
    return _serve(tasks)


def _fork(tasks, W):
    """Import once what each rank would, fork ``W`` ranks, and exit when
    they all have, or at once (the others killed) when one fails or the
    controller is gone."""
    import torch._dynamo  # noqa: F401  (torch.utils.checkpoint's)

    import paddle_tpu_torch.distributed.fleet  # noqa: F401
    ranks = {}
    for r in range(W):
        pid = os.fork()
        if pid == 0:
            os.environ.update(_rank_env(r))
            code = 1
            try:
                code = _serve(tasks)
            except BaseException:   # noqa: BLE001 - the rank's exit code
                traceback.print_exc()
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        ranks[pid] = r
    parent = os.getppid()
    code = 0
    while ranks:
        pid, status = os.waitpid(-1, os.WNOHANG)
        if pid == 0:
            if os.getppid() != parent:
                code = 1
                break
            time.sleep(0.05)
            continue
        del ranks[pid]
        if os.waitstatus_to_exitcode(status) != 0:
            code = 1
            break
    for pid in ranks:
        os.kill(pid, signal.SIGKILL)
    for pid in ranks:
        os.waitpid(pid, 0)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)      # nothing to tear down: the ranks held the job


def _serve(tasks) -> int:
    """A rank: join the job, then run the controller's tasks."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.store import TCPStore
    dist.init_parallel_env()
    rank = dist.get_rank()
    host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
    store = TCPStore(host, int(port))
    parent = os.getppid()
    n = 0
    while True:
        key = f"task/{n}"
        wait = 0.001
        while not store.check(key):
            if os.getppid() != parent:
                return 1
            # back off to 20 polls a second: idle ranks of many worlds
            # share the machine with the tests that run meanwhile
            time.sleep(wait)
            wait = min(2 * wait, 0.05)
        name, args = pickle.loads(store.get(key))
        if name == "stop":
            return 0
        try:
            res = ("ok", tasks[name](*args))
        except Exception:   # noqa: BLE001 - shipped to the controller
            res = ("error", traceback.format_exc())
        store.set(f"result/{n}/{rank}", pickle.dumps(res))
        n += 1


class World:
    """W ranks of ``script`` on ``devices`` (``cpu``, or a card id every
    rank shares), started through the launcher's environment, each
    running the tasks :meth:`run` names."""

    def __init__(self, W, script, devices="cpu"):
        from paddle_tpu_torch.distributed.launch.main import _free_port
        from paddle_tpu_torch.distributed.store import TCPStore
        self.W = W
        self.n = 0
        self.store = TCPStore(is_master=True, world_size=W)
        master = f"127.0.0.1:{self.store.port}"
        # the process group's store, on a free port as the launcher
        # takes one for each generation
        coordinator = f"127.0.0.1:{_free_port()}"
        env = dict(os.environ, PADDLE_TRAINERS_NUM=str(W),
                   PADDLE_MASTER=master, COORDINATOR_ADDRESS=coordinator,
                   PADDLE_TRAINER_ENDPOINTS=",".join(
                       f"127.0.0.1:{7000 + i}" for i in range(W)),
                   PADDLE_WORLD_DEVICES=",".join([devices] * W),
                   FLAGS_selected_gpus=devices, PYTHONPATH=ROOT,
                   OMP_NUM_THREADS="1")
        cmd = [sys.executable, os.path.abspath(script)]
        if devices == "cpu":
            self.procs = [subprocess.Popen(cmd, env={**env, FORK: str(W)})]
        else:
            self.procs = [subprocess.Popen(cmd, env={**env, **_rank_env(r)})
                          for r in range(W)]

    def run(self, name, *args, timeout=300):
        n, self.n = self.n, self.n + 1
        self.store.set(f"task/{n}", pickle.dumps((name, args)))
        keys = [f"result/{n}/{r}" for r in range(self.W)]
        end = time.monotonic() + timeout
        while not all(self.store.check(k) for k in keys):
            dead = [p.poll() for p in self.procs if p.poll() is not None]
            assert not dead, f"{name}: a rank exited: {dead}"
            if time.monotonic() >= end:
                waiting = [r for r, k in enumerate(keys)
                           if not self.store.check(k)]
                raise AssertionError(f"{name} timed out after {timeout} s "
                                     f"waiting for ranks {waiting}")
            time.sleep(0.005)
        out = []
        for k in keys:
            status, val = pickle.loads(self.store.get(k))
            assert status == "ok", val
            out.append(val)
        return out

    def close(self):
        self.store.set(f"task/{self.n}", pickle.dumps(("stop", ())))
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.store.stop()
