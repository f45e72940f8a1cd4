"""Spawned worlds of ranks over gloo for the port's multi-rank tests.

A world is W processes of one test file run as a script (the file ends
with ``sys.exit(serve(TASKS))``), each joined by ``init_parallel_env``
from the launcher's variables; the controller (the pytest process) names
a ``task_*`` function and its arguments through a ``TCPStore``, and every
rank sends back its result.  The ranks import torch and the port, never
jax.  One world is started per size per module and shared by its tests
(``tests/test_torch_distributed.py``, ``test_torch_fleet.py``,
``test_torch_sharding.py``; ``test_torch_cuda.py``'s ranks on the card).
"""

import os
import pickle
import subprocess
import sys
import time
import traceback
from datetime import timedelta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def serve(tasks) -> int:
    """A rank: join the job, then run the controller's tasks."""
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env()
    rank = dist.get_rank()
    host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
    store = tdist.TCPStore(host, int(port), None, False,
                           timedelta(seconds=600))
    parent = os.getppid()
    n = 0
    while True:
        key = f"task/{n}"
        while not store.check([key]):
            if os.getppid() != parent:
                return 1
            time.sleep(0.005)
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
        import torch.distributed as tdist
        self.W = W
        self.n = 0
        self.store = tdist.TCPStore("127.0.0.1", 0, None, True,
                                    timedelta(seconds=600),
                                    wait_for_workers=False)
        master = f"127.0.0.1:{self.store.port}"
        self.procs = []
        for r in range(W):
            env = dict(os.environ, PADDLE_TRAINER_ID=str(r),
                       PADDLE_TRAINERS_NUM=str(W), PADDLE_MASTER=master,
                       PADDLE_CURRENT_ENDPOINT=f"127.0.0.1:{7000 + r}",
                       PADDLE_TRAINER_ENDPOINTS=",".join(
                           f"127.0.0.1:{7000 + i}" for i in range(W)),
                       PADDLE_WORLD_DEVICES=",".join([devices] * W),
                       FLAGS_selected_gpus=devices, PYTHONPATH=ROOT,
                       OMP_NUM_THREADS="1")
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(script)], env=env))

    def run(self, name, *args, timeout=300):
        n, self.n = self.n, self.n + 1
        self.store.set(f"task/{n}", pickle.dumps((name, args)))
        keys = [f"result/{n}/{r}" for r in range(self.W)]
        end = time.monotonic() + timeout
        while not self.store.check(keys):
            dead = [p.poll() for p in self.procs if p.poll() is not None]
            assert not dead, f"a rank exited: {dead}"
            assert time.monotonic() < end, f"{name} timed out"
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
